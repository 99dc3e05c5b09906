// One token of Mamba-2's SSD recurrence for every row (kernel S3):
//
//     dec = exp(dt A),   h' = h * dec + (dt B) x,   y = C . h' + D x
//
// for each (row b, head h): h, h' f32 [N, hd], B and C [N], x [hd].
//
// A new kernel, not a TPU port: it fuses the JAX package's per-token state
// update and readout (src/repro/models/ssm.py ssm_decode, :181-190), which
// XLA fuses on its own and eager torch runs as ~7 kernels with two
// full-size temporaries.  It runs once per SSD layer per decode tick,
// inside the graphed tick, so it allocates nothing and never syncs: the
// wrapper (kernels/ssd_decode.py) allocates h' and y.
//
// Contract: h f32 [B, H, N, hd] contiguous; dt f32 [B, H]; A, D f32 [H]; B,
// C [B, N] and x [B, H * hd] in f32 or bf16 (widened here), each with its
// own row stride and contiguous rows (the decode step passes column slices
// of its xbc row); active (bytes, 0 or 1) [B] or null.  A row whose active
// byte is 0 keeps its state: h' = h.  h' f32 [B, H, N, hd] and y f32 [B, H,
// hd] are written once.  h' is h * dec + (dt * B[n]) * x[d] with IEEE
// multiplies and adds (no FMA), the plain version's order; y's sum over N
// is taken in a fixed order that does not depend on B: each thread sums
// its own n in increasing order, then the partial sums of the thread
// groups are added group by group.  So a row's bits are the same alone or
// in any batch (continuous batching == sequential decode), and y is within
// f32 rounding of the plain version's einsum.
//
// What bounds it on an H100: bytes.  h read once and h' written once, 8 B
// per state element and ~5 operations: at mamba2-130m's 8 serve slots,
// [8, 24, 128, 64], that is 12.6 MB a layer, 3.8 us at 3.35 TB/s.
//
// Design: one block of 256 threads per (b, h).  B, C and this head's x are
// widened into shared memory first.  hd divides 256; thread t owns column
// d = t % hd and the rows n = t / hd, t / hd + 256 / hd, ...: neighbouring
// threads read neighbouring floats of one state row, and a thread's loads
// are independent of each other (only its y partial sum chains).
#include <cstdint>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_decode_kernel(const float* __restrict__ h, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ bm,
                  long long b_stride, const T* __restrict__ cm,
                  long long c_stride, const T* __restrict__ xm,
                  long long x_stride, const float* __restrict__ D,
                  const unsigned char* __restrict__ active,
                  float* __restrict__ h_out, float* __restrict__ y, int nh,
                  int n, int hd) {
  extern __shared__ float smem[];
  float* sb = smem;      // B [n]
  float* sc = sb + n;    // C [n]
  float* sx = sc + n;    // x of this head [hd]
  float* part = sx + hd;  // partial sums of y [kThreads]
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int hh = bh % nh;
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) {
    sb[i] = to_f32(bm[b * b_stride + i]);
    sc[i] = to_f32(cm[b * c_stride + i]);
  }
  for (int i = tid; i < hd; i += kThreads)
    sx[i] = to_f32(xm[b * x_stride + (long long)hh * hd + i]);
  __syncthreads();

  const float dtv = dt[bh];
  const float dec = expf(__fmul_rn(dtv, A[hh]));
  const bool live = active == nullptr || active[b] != 0;
  const int groups = kThreads / hd;
  const int d = tid % hd;
  const int g = tid / hd;
  const float xd = sx[d];
  const long long base = (long long)bh * n * hd + d;
  float acc = 0.f;
#pragma unroll 8
  for (int j = g; j < n; j += groups) {
    const long long off = base + (long long)j * hd;
    const float hv = h[off];
    const float hn =
        live ? __fadd_rn(__fmul_rn(hv, dec),
                         __fmul_rn(__fmul_rn(dtv, sb[j]), xd))
             : hv;
    h_out[off] = hn;
    acc = __fadd_rn(acc, __fmul_rn(sc[j], hn));
  }
  part[tid] = acc;
  __syncthreads();
  if (g == 0) {
    float s = part[d];
    for (int k = 1; k < groups; ++k) s = __fadd_rn(s, part[k * hd + d]);
    y[(long long)bh * hd + d] = __fadd_rn(s, __fmul_rn(D[hh], xd));
  }
}

template <typename T>
int launch(const void* h, const void* dt, const void* A, const void* bm,
           long long b_stride, const void* cm, long long c_stride,
           const void* xm, long long x_stride, const void* D,
           const void* active, void* h_out, void* y, int batch, int nh, int n,
           int hd, cudaStream_t stream) {
  const int smem = (2 * n + hd + kThreads) * (int)sizeof(float);
  ssd_decode_kernel<T><<<batch * nh, kThreads, smem, stream>>>(
      (const float*)h, (const float*)dt, (const float*)A, (const T*)bm,
      b_stride, (const T*)cm, c_stride, (const T*)xm, x_stride,
      (const float*)D, (const unsigned char*)active, (float*)h_out,
      (float*)y, nh, n, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: repro::kFloat32 or kBFloat16, the type of B, C and x.  Strides are
// in elements.  Shapes, contiguity and hd | 256 are the wrapper's checks.
extern "C" int repro_ssd_decode(int dtype, const void* h, const void* dt,
                                const void* A, const void* bm,
                                long long b_stride, const void* cm,
                                long long c_stride, const void* xm,
                                long long x_stride, const void* D,
                                const void* active, void* h_out, void* y,
                                int batch, int nh, int n, int hd,
                                void* stream) {
  if (batch < 0 || nh < 0 || n < 0 || hd <= 0 || kThreads % hd != 0 ||
      (long long)batch * nh > 2147483647LL ||
      (2LL * n + hd + kThreads) * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || nh == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == repro::kFloat32)
    return launch<float>(h, dt, A, bm, b_stride, cm, c_stride, xm, x_stride,
                         D, active, h_out, y, batch, nh, n, hd, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(h, dt, A, bm, b_stride, cm, c_stride, xm,
                                 x_stride, D, active, h_out, y, batch, nh, n,
                                 hd, st);
  return (int)cudaErrorInvalidValue;
}
