// Row normalisation over the last dim (kernel S4):
//
//     RMSNorm:    y = x * rsqrt(mean(x^2) + eps) * scale
//     LayerNorm:  y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * scale + bias
//
// with f32 statistics and f32 scale/bias, y in x's dtype (bf16 or f32).
//
// A new kernel, not a TPU port: the JAX package's apply_norm
// (src/repro/models/layers.py) is an expression that XLA fuses into one
// pass.  Eager PyTorch runs it as 7 (RMSNorm) to 11 (LayerNorm) kernels
// with f32 temporaries of the whole input, ~36 B moved an element where a
// pass needs 4 (bf16 in and out).  It runs twice in every block of every
// model step, and once more before the head.
//
// What bounds it on an H100: bytes.  x read once, y written once, scale and
// bias once per row from L1/L2: granite-20b's prefill norm, [1774, 6144]
// bf16, is 43.6 MB, 13 us at 3.35 TB/s.
//
// Design: one block of 256 threads per row.  A thread loads its VPT
// chunks of VEC elements (16 bytes each where the row, its stride and the
// scale allow, else one element) into registers once, as f32; chunks past
// VPT * 256 (rows longer than the register cache) are read again in each
// pass.  The statistics are summed in a fixed order: each thread over its
// own chunks in increasing order, then common.cuh's block_sum.  So a row's
// output does not depend on how many rows are launched with it.  Every
// step is the plain version's (kernels/ref.py norm_plain) f32 operation,
// rounded alone (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction),
// with the mean a product by 1/d and rsqrtf as the eager rsqrt: the output
// differs from the eager expression only by the order of its sums.
//
// Contract: x [rows, d] reached as (row / inner) * outer_stride + (row %
// inner) * inner_stride, elements contiguous along d; scale (and bias) f32
// [d] contiguous; y [rows, d] contiguous, written once.  bias == nullptr is
// RMSNorm.  vec != 0: x, its strides and scale/bias allow 16-byte access
// and VEC divides d (the wrapper's check).
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[VEC]) {
  alignas(16) T raw[VEC];
  load_vec<T, VEC>(p, raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = to_f32(raw[e]);
}

template <int VEC>
__device__ __forceinline__ void load_param(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + e));
      v[e] = f.x; v[e + 1] = f.y; v[e + 2] = f.z; v[e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __ldg(p + e);
  }
}

// The statistic's summand of one element: x (LayerNorm's mean), (x - mu)^2
// (its variance) or x^2 (RMSNorm).
enum Pass { kSum, kCentred, kSquare };

template <Pass P, int VEC>
__device__ __forceinline__ float add_chunk(float acc, const float (&v)[VEC],
                                           float mu) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (P == kSum) {
      acc = __fadd_rn(acc, v[e]);
    } else {
      const float c = P == kCentred ? __fsub_rn(v[e], mu) : v[e];
      acc = __fadd_rn(acc, __fmul_rn(c, c));
    }
  }
  return acc;
}

template <typename T, int VEC>
__device__ __forceinline__ void write_chunk(T* y, const float (&v)[VEC],
                                            const float* scale,
                                            const float* bias, float mu,
                                            float r) {
  float s[VEC], b[VEC];
  alignas(16) T out[VEC];
  load_param<VEC>(scale, s);
  if (bias != nullptr) {
    load_param<VEC>(bias, b);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = from_f32<T>(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[e], mu), r), s[e]), b[e]));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = from_f32<T>(__fmul_rn(__fmul_rn(v[e], r), s[e]));
  }
  store_vec<T, VEC>(y, out);
}

// Up to 3 chunks a thread, 4 blocks (rows) share an SM: enough bytes in
// flight for granite-20b's rows of 768 chunks.
template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(kThreads, VPT <= 3 ? 4 : 1)
norm_rows_kernel(const T* __restrict__ x, long long outer_stride,
                 long long inner_stride, int inner,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ y, int d,
                 float eps) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + (row / inner) * outer_stride + (row % inner) * inner_stride;
  T* yr = y + row * d;
  const int nvec = d / VEC;
  const int tid = threadIdx.x;
  const float inv_d = __fdiv_rn(1.0f, (float)d);
  const bool ln = bias != nullptr;

  float v[VPT][VEC];
  float t[VEC];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * kThreads;
    if (i < nvec) {
      load_f32<T, VEC>(xr + (long long)i * VEC, v[k]);
      acc = ln ? add_chunk<kSum>(acc, v[k], 0.f)
               : add_chunk<kSquare>(acc, v[k], 0.f);
    }
  }
  for (int i = tid + VPT * kThreads; i < nvec; i += kThreads) {
    load_f32<T, VEC>(xr + (long long)i * VEC, t);
    acc = ln ? add_chunk<kSum>(acc, t, 0.f) : add_chunk<kSquare>(acc, t, 0.f);
  }
  const float s1 = block_sum<kThreads>(acc, red);

  float mu = 0.f, r;
  if (ln) {
    mu = __fmul_rn(s1, inv_d);
    acc = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (tid + k * kThreads < nvec) acc = add_chunk<kCentred>(acc, v[k], mu);
    for (int i = tid + VPT * kThreads; i < nvec; i += kThreads) {
      load_f32<T, VEC>(xr + (long long)i * VEC, t);
      acc = add_chunk<kCentred>(acc, t, mu);
    }
    const float s2 = block_sum<kThreads>(acc, red);
    r = rsqrtf(__fadd_rn(__fmul_rn(s2, inv_d), eps));
  } else {
    r = rsqrtf(__fadd_rn(__fmul_rn(s1, inv_d), eps));
  }

#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tid + k * kThreads;
    if (i < nvec)
      write_chunk<T, VEC>(yr + (long long)i * VEC, v[k], scale + i * VEC,
                          bias == nullptr ? nullptr : bias + i * VEC, mu, r);
  }
  for (int i = tid + VPT * kThreads; i < nvec; i += kThreads) {
    load_f32<T, VEC>(xr + (long long)i * VEC, t);
    write_chunk<T, VEC>(yr + (long long)i * VEC, t, scale + i * VEC,
                        bias == nullptr ? nullptr : bias + i * VEC, mu, r);
  }
}

template <typename T, int VEC>
int launch(const void* x, long long outer_stride, long long inner_stride,
           long long rows, int inner, const void* scale, const void* bias,
           void* y, int d, float eps, cudaStream_t stream) {
  const int need = (d / VEC + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)rows);
#define REPRO_NORM_LAUNCH(VPT)                                              \
  norm_rows_kernel<T, VEC, VPT><<<grid, kThreads, 0, stream>>>(             \
      (const T*)x, outer_stride, inner_stride, inner, (const float*)scale,  \
      (const float*)bias, (T*)y, d, eps)
  if (need <= 1)
    REPRO_NORM_LAUNCH(1);
  else if (need <= 2)
    REPRO_NORM_LAUNCH(2);
  else if (need <= 3)
    REPRO_NORM_LAUNCH(3);
  else if (need <= 4)
    REPRO_NORM_LAUNCH(4);
  else
    REPRO_NORM_LAUNCH(8);
#undef REPRO_NORM_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: repro::kFloat32 or kBFloat16, the type of x and y.  Strides are in
// elements.  bias null: RMSNorm.  Shapes, dtypes and the 16-byte conditions
// of vec are the wrapper's checks.
extern "C" int repro_norm(int dtype, int vec, const void* x,
                          long long outer_stride, long long inner_stride,
                          long long rows, int inner, const void* scale,
                          const void* bias, void* y, int d, float eps,
                          void* stream) {
  if (rows < 0 || rows > 2147483647LL || inner <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return vec ? repro::launch<float, 4>(x, outer_stride, inner_stride, rows,
                                         inner, scale, bias, y, d, eps, st)
               : repro::launch<float, 1>(x, outer_stride, inner_stride, rows,
                                         inner, scale, bias, y, d, eps, st);
  if (dtype == repro::kBFloat16)
    return vec ? repro::launch<__nv_bfloat16, 8>(x, outer_stride,
                                                 inner_stride, rows, inner,
                                                 scale, bias, y, d, eps, st)
               : repro::launch<__nv_bfloat16, 1>(x, outer_stride,
                                                 inner_stride, rows, inner,
                                                 scale, bias, y, d, eps, st);
  return (int)cudaErrorInvalidValue;
}
