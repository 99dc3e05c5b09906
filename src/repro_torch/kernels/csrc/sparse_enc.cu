// K3: block-COO sparse encode (tensor_sparse_enc, the sparse wire codec).
//
// Replaces sparse_enc_pallas (_enc_kernel) of src/repro/kernels/sparse_enc.py.
//
// Contract (bitwise against sparse_enc_xla): the flat input is cut into
// blocks of 512; block b keeps its first kb elements with
// |float(x)| > threshold, in position order, as (value in the source dtype,
// unchanged; index base_b + i); slots from cnt = min(nnz, kb) up to kb hold
// (0, base_b).  base_b = (b mod frame_blocks) * 512: the global block base
// for frame_blocks == nb, the frame-local one when nb blocks are a stack of
// frames of frame_blocks blocks each.  Optionally totals[b] = nnz, the
// uncapped count (the codec's truncation accounting).  Finite inputs only:
// the TPU kernel compacts with a one-hot matmul, which a NaN or Inf
// anywhere in the block poisons, while sparse_enc_xla and this kernel carry
// them like any value — the two references agree only on finite data.
//
// What bounds it on an H100: bytes (4 or 2 B in per element, 8 or 6 B out
// per slot, 8 B per block for the counts).  The TPU compacts with one-hot
// MXU matmuls; Hopper has warp ballots.  The design is about keeping both
// directions of memory traffic dense:
// * One warp per 512-element block, 8 blocks per CTA.  A lane issues all of
//   its block's loads before it uses any: C 16-byte loads (f32: 4 x 4
//   elements, bf16: 2 x 8), each warp-wide load one coalesced 512-byte row,
//   marked evict-first (the input is read once).  That is 2 KB in flight
//   per warp, up to 128 KB per SM, against ~20 KB that HBM latency needs.
// * Rank without a barrier.  In chunk c lane l holds the E consecutive
//   elements c*32E + lE .. c*32E + lE + E-1, so the elements of the chunk
//   ahead of its element j are those of lanes < l and its own below j.  A
//   lane's kept count k (0..E) goes through one ballot per bit of k: rank =
//   off_c + sum_s 2^s popc(ballot_s & lanemask_lt) + popc(own bits below
//   j), and off_{c+1} = off_c + sum_s 2^s popc(ballot_s).  Integer
//   arithmetic, no atomics: the output is the same on every run.
// * Stores through shared memory.  Kept elements with rank < kb go to the
//   warp's kb staging slots; after a __syncwarp the lanes write slots
//   0..kb-1 (empty ones as (0, base_b)) with coalesced stores.  On an H100
//   SXM (700 W) at f32 [8 * 2^20], kb = 80 (chip_smoke.py phase 3c),
//   storing the kept elements straight from their lanes (one predicated
//   store instruction per register, each writing a few scattered slots)
//   took 0.0227 ms; staged, 0.0165 ms.
// Values move as raw bits, so every value (-0.0 included) is carried
// unchanged.  A base pointer that is not 16-byte aligned takes the
// kScalar instantiation: the same kernel with one load per element.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kB = 512;          // elements per sparse block
constexpr int kWarps = 8;        // sparse blocks (warps) per CTA

template <typename T>
struct Raw;                      // the element's bits
template <>
struct Raw<float> {
  using type = uint32_t;
  __device__ static float f32(uint32_t r) { return __uint_as_float(r); }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint16_t;
  __device__ static float f32(uint16_t r) {
    return __uint_as_float((uint32_t)r << 16);   // bf16 -> f32 is exact
  }
};

template <typename T, bool kScalar>
__global__ void __launch_bounds__(kWarps * 32)
sparse_enc_kernel(const T* __restrict__ x, T* __restrict__ vals_,
                  int32_t* __restrict__ idx, int32_t* __restrict__ cnt,
                  int32_t* __restrict__ totals, int nb, int kb,
                  int frame_blocks, float threshold) {
  using R = typename Raw<T>::type;
  constexpr int E = 16 / sizeof(T);           // elements per lane per chunk
  constexpr int C = kB / (32 * E);            // chunks per block: 4 or 2
  constexpr int kBits = E == 4 ? 3 : 4;       // bits of a lane count 0..E
  extern __shared__ int32_t stage[];          // [kWarps][kb] idx, then vals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= nb) return;                        // warp-uniform
  const long long in0 = (long long)b * kB;
  R e[C][E];
  if constexpr (kScalar) {
    const R* xr = reinterpret_cast<const R*>(x) + in0;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < E; ++j)
        e[c][j] = __ldcs(xr + c * 32 * E + lane * E + j);
  } else {
    const uint4* xv = reinterpret_cast<const uint4*>(x + in0);
    uint4 w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = __ldcs(xv + c * 32 + lane);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t u[4] = {w[c].x, w[c].y, w[c].z, w[c].w};
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if constexpr (E == 4)
          e[c][j] = (R)u[j];
        else                           // element 2i in the low half of u[i]
          e[c][j] = (R)(u[j / 2] >> (16 * (j % 2)));
      }
    }
  }
  int32_t* s_idx = stage + warp * kb;
  R* s_val = reinterpret_cast<R*>(stage + kWarps * kb) + warp * kb;
  const int base = (int)((long long)(b % frame_blocks) * kB);
  const unsigned lt = (1u << lane) - 1u;
  int off = 0;                                // kept elements before chunk c
#pragma unroll
  for (int c = 0; c < C; ++c) {
    unsigned own = 0;
#pragma unroll
    for (int j = 0; j < E; ++j)
      own |= (unsigned)(fabsf(Raw<T>::f32(e[c][j])) > threshold) << j;
    const int k = __popc(own);
    int before = 0, sum = 0;
#pragma unroll
    for (int s = 0; s < kBits; ++s) {
      const unsigned m = __ballot_sync(0xffffffffu, (k >> s) & 1);
      before += __popc(m & lt) << s;
      sum += __popc(m) << s;
    }
    const int r0 = off + before;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int rank = r0 + __popc(own & ((1u << j) - 1u));
      if (((own >> j) & 1u) && rank < kb) {
        s_val[rank] = e[c][j];
        s_idx[rank] = base + c * 32 * E + lane * E + j;
      }
    }
    off += sum;
  }
  __syncwarp();
  const int used = min(off, kb);
  R* vals = reinterpret_cast<R*>(vals_);
  const long long out0 = (long long)b * kb;
  for (int s = lane; s < kb; s += 32) {
    vals[out0 + s] = s < used ? s_val[s] : (R)0;
    idx[out0 + s] = s < used ? s_idx[s] : base;
  }
  if (lane == 0) {
    cnt[b] = used;
    if (totals != nullptr) totals[b] = off;
  }
}

template <typename T>
void launch(bool vec16, const void* x, void* vals, void* idx, void* cnt,
            void* totals, int nb, int kb, int frame_blocks, float threshold,
            cudaStream_t s) {
  const int grid = (nb + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * kb * (4 + sizeof(T));  // <= 32 KB
  auto k = vec16 ? &sparse_enc_kernel<T, false>
                  : &sparse_enc_kernel<T, true>;
  k<<<grid, kWarps * 32, smem, s>>>((const T*)x, (T*)vals, (int32_t*)idx,
                                    (int32_t*)cnt, (int32_t*)totals, nb, kb,
                                    frame_blocks, threshold);
}

}  // namespace

// flat [nb*512] (f32 or bf16) -> vals [nb*kb] (same dtype), idx int32
// [nb*kb], cnt int32 [nb], and totals int32 [nb] unless it is null;
// 1 <= kb <= 512, frame_blocks divides nb, frame_blocks*512 <= 2^31 (the
// wrapper checks).  vec16 selects the 16-byte loads, which need a 16-byte
// aligned x; a misaligned x with vec16 set is refused.
extern "C" int repro_sparse_enc(int dtype, int vec16, const void* x,
                                void* vals, void* idx, void* cnt,
                                void* totals, int nb, int kb,
                                int frame_blocks, float threshold,
                                void* stream) {
  if (vec16 && ((uintptr_t)x & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (nb > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == repro::kFloat32)
      launch<float>(vec16, x, vals, idx, cnt, totals, nb, kb, frame_blocks,
                    threshold, s);
    else
      launch<__nv_bfloat16>(vec16, x, vals, idx, cnt, totals, nb, kb,
                            frame_blocks, threshold, s);
  }
  return (int)cudaGetLastError();
}
