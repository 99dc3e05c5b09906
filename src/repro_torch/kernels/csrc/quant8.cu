// K1 and K2: per-tile symmetric int8 quantization of a wire frame.
//
// Replaces quantize8_pallas / dequantize8_pallas (_quant_kernel,
// _dequant_kernel) of src/repro/kernels/quant8.py.
//
// Contract (bitwise against quantize8_xla / dequantize8_xla):
//   K1: for each (32, 128) tile of x f32 [M, N] (M % 32 == N % 128 == 0),
//       scale = amax * f32(1/127), or 1.0 when amax == 0;
//       q = round_half_even(x / scale) with an IEEE division.
//       (The reference writes amax / 127.0; XLA folds it into a multiply by
//       the f32 reciprocal, on both of its routes, so the port does too.)
//   K2: x = float(q) * scale per tile.
//
// What bounds them on an H100: bytes.  K1 reads 4 B and writes 1 B per
// element (+4 B per tile), K2 the reverse; a handful of instructions per
// element.  Design: one block of 256 threads per tile; each thread moves 16
// elements as four 16-byte (float4) or 4-byte (char4) accesses, rows of a
// warp on contiguous addresses.  amax is a max of |x|, exact in any order,
// so the warp-shuffle + shared-memory reduction needs no fixed order.  The
// division is `/` compiled without --use_fast_math (IEEE round to nearest)
// and the rounding is rintf (half to even), never roundf.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 32;
constexpr int kBN = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / (kBN / 4);   // 8 rows per pass
constexpr float kInv127 = 1.0f / 127.0f;

__global__ void __launch_bounds__(kThreads)
quantize8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scales, int gn, long long n) {
  const int tile = blockIdx.x;
  const int ti = tile / gn, tj = tile % gn;
  const int c4 = threadIdx.x % (kBN / 4);        // float4 column in the tile
  const int r0 = threadIdx.x / (kBN / 4);        // first row of this thread
  const long long base = (long long)ti * kBM * n + (long long)tj * kBN + 4 * c4;

  float4 v[kBM / kRowsPerPass];
  float amax = 0.f;
#pragma unroll
  for (int p = 0; p < kBM / kRowsPerPass; ++p) {
    const long long off = base + (long long)(r0 + p * kRowsPerPass) * n;
    v[p] = *reinterpret_cast<const float4*>(x + off);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[p].x), fabsf(v[p].y)),
                             fmaxf(fabsf(v[p].z), fabsf(v[p].w))));
  }
  __shared__ float red[kThreads / 32];
  amax = repro::block_max<kThreads>(amax, red);
  const float scale = amax > 0.f ? amax * kInv127 : 1.0f;
#pragma unroll
  for (int p = 0; p < kBM / kRowsPerPass; ++p) {
    const long long off = base + (long long)(r0 + p * kRowsPerPass) * n;
    char4 o;
    o.x = (signed char)(int)rintf(__fdiv_rn(v[p].x, scale));
    o.y = (signed char)(int)rintf(__fdiv_rn(v[p].y, scale));
    o.z = (signed char)(int)rintf(__fdiv_rn(v[p].z, scale));
    o.w = (signed char)(int)rintf(__fdiv_rn(v[p].w, scale));
    *reinterpret_cast<char4*>(q + off) = o;
  }
  if (threadIdx.x == 0) scales[tile] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize8_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scales, float* __restrict__ x,
                   int gn, long long n) {
  const int tile = blockIdx.x;
  const int ti = tile / gn, tj = tile % gn;
  const int c4 = threadIdx.x % (kBN / 4);
  const int r0 = threadIdx.x / (kBN / 4);
  const long long base = (long long)ti * kBM * n + (long long)tj * kBN + 4 * c4;
  const float scale = scales[tile];
#pragma unroll
  for (int p = 0; p < kBM / kRowsPerPass; ++p) {
    const long long off = base + (long long)(r0 + p * kRowsPerPass) * n;
    const char4 c = *reinterpret_cast<const char4*>(q + off);
    float4 o;
    o.x = (float)c.x * scale;
    o.y = (float)c.y * scale;
    o.z = (float)c.z * scale;
    o.w = (float)c.w * scale;
    *reinterpret_cast<float4*>(x + off) = o;
  }
}

}  // namespace

// x f32 [m, n] -> q int8 [m, n], scales f32 [m/32, n/128]; every pointer
// 16-byte aligned, m % 32 == n % 128 == 0 (the wrapper checks).
extern "C" int repro_quantize8(const void* x, void* q, void* scales, int m,
                               int n, void* stream) {
  const int gm = m / kBM, gn = n / kBN;
  if (gm > 0 && gn > 0)
    quantize8_kernel<<<gm * gn, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)scales, gn, n);
  return (int)cudaGetLastError();
}

extern "C" int repro_dequantize8(const void* q, const void* scales, void* x,
                                 int m, int n, void* stream) {
  const int gm = m / kBM, gn = n / kBN;
  if (gm > 0 && gn > 0)
    dequantize8_kernel<<<gm * gn, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const float*)scales, (float*)x, gn, n);
  return (int)cudaGetLastError();
}
