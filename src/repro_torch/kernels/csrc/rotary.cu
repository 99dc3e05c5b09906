// Rotary position embedding on interleaved pairs (kernel S5): for each
// token (b, s) at position p, each head of q (and of k) and each pair i <
// rot / 2 of its leading rot elements,
//
//     f_i = 1 / theta^(2i / rot),   a = p * f_i
//     y[2i]     = x[2i] cos a - x[2i+1] sin a
//     y[2i + 1] = x[2i+1] cos a + x[2i] sin a
//
// and y = x past rot (partial rotary).  Computed in f32, written in x's
// dtype (bf16 or f32).  Given a table freqs (f32 [rot / 2], YaRN's:
// models/mla.py), f_i = freqs[i] in place of theta^(-2i / rot).
//
// A new kernel, not a TPU port: the JAX package's apply_rope
// (src/repro/models/layers.py) is an expression that XLA fuses.  Eager
// PyTorch rebuilds the angle table and runs ~25 kernels a tensor, with f32
// temporaries of the rotated part; a layer rotates q and k, so its model
// step paid ~50 launches where this is one.
//
// What bounds it on an H100: bytes.  q and k read once and written once:
// granite-20b's prefill of 1774 tokens, q [1774, 48, 128] and k [1774, 1,
// 128] bf16, is 44.5 MB, 13 us at 3.35 TB/s; the cos/sin table is computed
// once a token for all its heads, in shared memory.
//
// Bitwise the eager expression on the card.  Every step is the f32
// operation eager PyTorch runs there, rounded alone (__fmul_rn / __fsub_rn
// / __fadd_rn: no FMA contraction):
//   * 2i / rot: a product by the f32 reciprocal of rot, as PyTorch's CUDA
//     division by a host scalar computes it;
//   * theta ^ e: powf, theta rounded to f32;
//   * 1 / t: the IEEE reciprocal (Tensor.__rtruediv__ is reciprocal() * 1.0,
//     and the product by 1.0 is exact);
//   * float(p) * f_i (f_i read from the table where one is given), then
//     cosf and sinf;
//   * the four products and the difference and sum of the plain version
//     (kernels/ref.py rotary_plain), then one rounding to bf16.
// The untouched part is copied as it is.
//
// Contract: q [B, S, Hq, hd] (and k [B, S, Hk, hd]) with element strides
// (qb, qs, qh, 1); positions int32 or int64 reached as b * pb + s * ps
// (stride 0 broadcasts); outputs contiguous [B, S, H, hd], written once.
// vec != 0: 16-byte chunks (x, its strides allow it and 16 / sizeof(T)
// divides hd: the wrapper's check), else element by element.  One block of
// 128 threads a token; the kernel reads the positions on the device, so a
// CUDA graph captures it.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;

template <typename T, int VEC, typename P>
__global__ void __launch_bounds__(kThreads)
rotary_kernel(const T* __restrict__ q, long long qb, long long qs,
              long long qh, int hq, const T* __restrict__ k, long long kb,
              long long ks, long long kh, int hk, const P* __restrict__ pos,
              long long pb, long long ps, const float* __restrict__ freqs,
              T* __restrict__ q_out, T* __restrict__ k_out, int seq, int hd,
              int rot, float theta) {
  extern __shared__ float tab[];  // cos [rot / 2], then sin [rot / 2]
  const int row = blockIdx.x;     // b * seq + s
  const int b = row / seq;
  const int s = row - b * seq;
  const int half = rot / 2;
  const float inv_rot = __fdiv_rn(1.0f, (float)rot);
  const float p = (float)pos[b * pb + s * ps];
  for (int i = threadIdx.x; i < half; i += kThreads) {
    const float f =
        freqs != nullptr
            ? freqs[i]
            : __fmul_rn(__frcp_rn(powf(theta, __fmul_rn((float)(2 * i),
                                                         inv_rot))),
                        1.0f);
    const float a = __fmul_rn(p, f);
    tab[i] = cosf(a);
    tab[half + i] = sinf(a);
  }
  __syncthreads();

  const int cph = hd / VEC;  // chunks a head
  const int total = (hq + hk) * cph;
  for (int c = threadIdx.x; c < total; c += kThreads) {
    const int h = c / cph;
    const int j0 = (c - h * cph) * VEC;
    const T* src;
    T* dst;
    if (h < hq) {
      src = q + b * qb + s * qs + h * qh + j0;
      dst = q_out + ((long long)row * hq + h) * hd + j0;
    } else {
      src = k + b * kb + s * ks + (h - hq) * kh + j0;
      dst = k_out + ((long long)row * hk + (h - hq)) * hd + j0;
    }
    alignas(16) T in[VEC];
    alignas(16) T out[VEC];
    load_vec<T, VEC>(src, in);
#pragma unroll
    for (int e = 0; e < VEC; e += 2) {
      const int j = j0 + e;
      if (j < rot) {
        const float cs = tab[j / 2];
        const float sn = tab[half + j / 2];
        const float x1 = to_f32(in[e]);
        const float x2 = to_f32(in[e + 1]);
        out[e] = from_f32<T>(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)));
        out[e + 1] =
            from_f32<T>(__fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn)));
      } else {
        out[e] = in[e];
        out[e + 1] = in[e + 1];
      }
    }
    store_vec<T, VEC>(dst, out);
  }
}

template <typename T, int VEC>
int launch(int pos_code, const void* q, long long qb, long long qs,
           long long qh, int hq, const void* k, long long kb, long long ks,
           long long kh, int hk, const void* pos, long long pb, long long ps,
           const float* freqs, void* q_out, void* k_out, int rows, int seq,
           int hd, int rot, float theta, cudaStream_t stream) {
  const int smem = rot * (int)sizeof(float);
#define REPRO_ROTARY_LAUNCH(P)                                               \
  rotary_kernel<T, VEC, P><<<rows, kThreads, smem, stream>>>(                \
      (const T*)q, qb, qs, qh, hq, (const T*)k, kb, ks, kh, hk,              \
      (const P*)pos, pb, ps, freqs, (T*)q_out, (T*)k_out, seq, hd, rot, theta)
  if (pos_code == 0)
    REPRO_ROTARY_LAUNCH(int32_t);
  else
    REPRO_ROTARY_LAUNCH(int64_t);
#undef REPRO_ROTARY_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: repro::kFloat32 or kBFloat16, the type of q, k and the outputs;
// pos_code 0: int32 positions, 1: int64.  Strides are in elements; hk 0
// (k and k_out null) rotates q alone; freqs null computes the frequencies
// from theta.  Shapes, dtypes and the conditions of vec are the wrapper's
// checks.
extern "C" int repro_rotary(int dtype, int vec, int pos_code, const void* q,
                            long long qb, long long qs, long long qh, int hq,
                            const void* k, long long kb, long long ks,
                            long long kh, int hk, const void* pos,
                            long long pb, long long ps, const float* freqs,
                            void* q_out, void* k_out, int batch, int seq,
                            int hd, int rot, float theta, void* stream) {
  const long long rows = (long long)batch * seq;
  if (batch < 0 || seq < 0 || hq < 0 || hk < 0 || hd <= 0 || rot < 2 ||
      rot > hd || rot % 2 != 0 || rows > 2147483647LL ||
      (pos_code != 0 && pos_code != 1) || rot * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || hq + hk == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int r = (int)rows;
  if (dtype == repro::kFloat32)
    return vec ? repro::launch<float, 4>(pos_code, q, qb, qs, qh, hq, k, kb,
                                         ks, kh, hk, pos, pb, ps, freqs, q_out, k_out,
                                         r, seq, hd, rot, theta, st)
               : repro::launch<float, 2>(pos_code, q, qb, qs, qh, hq, k, kb,
                                         ks, kh, hk, pos, pb, ps, freqs, q_out, k_out,
                                         r, seq, hd, rot, theta, st);
  if (dtype == repro::kBFloat16)
    return vec ? repro::launch<__nv_bfloat16, 8>(
                     pos_code, q, qb, qs, qh, hq, k, kb, ks, kh, hk, pos, pb,
                     ps, freqs, q_out, k_out, r, seq, hd, rot, theta, st)
               : repro::launch<__nv_bfloat16, 2>(
                     pos_code, q, qb, qs, qh, hq, k, kb, ks, kh, hk, pos, pb,
                     ps, freqs, q_out, k_out, r, seq, hd, rot, theta, st);
  return (int)cudaErrorInvalidValue;
}
