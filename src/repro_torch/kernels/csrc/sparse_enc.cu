// K3: block-COO sparse encode (tensor_sparse_enc, the sparse wire codec).
//
// Replaces sparse_enc_pallas (_enc_kernel) of src/repro/kernels/sparse_enc.py.
//
// Contract (bitwise against sparse_enc_xla): the flat input is cut into
// blocks of 512; block b keeps its first kb elements with
// |float(x)| > threshold, in position order, as (value in the source dtype,
// unchanged; global index b*512 + i); slots from cnt = min(nnz, kb) up to kb
// hold (0, b*512).  Finite inputs only: the TPU kernel compacts with a
// one-hot matmul, which a NaN or Inf anywhere in the block poisons, while
// sparse_enc_xla and this kernel carry them like any value — the two
// references agree only on finite data.
//
// What bounds it on an H100: bytes (4 B in per element, 8 B out per slot).
// The TPU compacts with one-hot MXU matmuls; Hopper has warp ballots.
// Design: one block of 512 threads per 512-element block, one element per
// thread.  __ballot_sync + __popc give each element its rank in its warp, a
// scan over the 16 warp counts in shared memory gives the block-wide rank,
// and an element whose rank is below kb writes slot `rank`.  The empty
// slots are then filled by the block's threads in turn.  No atomics, so the
// output is the same on every run.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kB = 512;
constexpr int kWarps = kB / 32;

template <typename T>
__global__ void __launch_bounds__(kB)
sparse_enc_kernel(const T* __restrict__ x, T* __restrict__ vals,
                  int32_t* __restrict__ idx, int32_t* __restrict__ cnt, int kb,
                  float threshold) {
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long gi = (long long)b * kB + t;
  const T v = x[gi];
  const bool keep = fabsf(repro::to_f32(v)) > threshold;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  __shared__ int warp_count[kWarps];
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  const int rank = before + __popc(ballot & ((1u << lane) - 1u));
  const long long out = (long long)b * kb;
  if (keep && rank < kb) {
    vals[out + rank] = v;
    idx[out + rank] = (int32_t)gi;
  }
  const int used = min(total, kb);
  for (int s = used + t; s < kb; s += kB) {
    vals[out + s] = repro::from_f32<T>(0.f);
    idx[out + s] = (int32_t)((long long)b * kB);
  }
  if (t == 0) cnt[b] = used;
}

}  // namespace

// flat [nb*512] (f32 or bf16) -> vals [nb*kb] (same dtype), idx int32
// [nb*kb], cnt int32 [nb]; 1 <= kb <= 512, nb*512 < 2^31 (the wrapper checks).
extern "C" int repro_sparse_enc(int dtype, const void* x, void* vals,
                                void* idx, void* cnt, int nb, int kb,
                                float threshold, void* stream) {
  if (nb > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == repro::kFloat32)
      sparse_enc_kernel<float><<<nb, kB, 0, s>>>(
          (const float*)x, (float*)vals, (int32_t*)idx, (int32_t*)cnt, kb,
          threshold);
    else
      sparse_enc_kernel<__nv_bfloat16><<<nb, kB, 0, s>>>(
          (const __nv_bfloat16*)x, (__nv_bfloat16*)vals, (int32_t*)idx,
          (int32_t*)cnt, kb, threshold);
  }
  return (int)cudaGetLastError();
}
