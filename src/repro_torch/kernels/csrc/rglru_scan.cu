// The RG-LRU linear recurrence of a whole sequence: h_t = a_t * h_{t-1} + bx_t.
//
// A new kernel, not a TPU port: the JAX package runs this recurrence as
// jax.lax.associative_scan (src/repro/models/rglru.py rglru_train and
// src/repro/models/transformer.py _rglru_prefill_cache), which XLA lowers
// to a log-depth tree of elementwise passes.  torch has no counterpart, and
// a Python loop over positions would launch a few small ops per token in
// every recurrent layer.
//
// Contract: a, bx, h f32 [B, S, W], contiguous; h_{-1} = 0.  Each step is
// an IEEE multiply then an IEEE add (__fmul_rn / __fadd_rn, never an FMA),
// in sequence order, one chain per (row, channel), so the result is bitwise
// the plain step-by-step loop (kernels/ref.py rglru_scan_plain) and the
// per-token decode update (models/rglru.py rglru_decode: h * a + bx).  A
// row's bits depend on its own a and bx only: not on B or the grid.
//
// What bounds it on an H100: bytes.  Two f32 inputs read once and one f32
// output written once, 12 B per element and one multiply-add: at
// [1, 3000, 4096] that is 147 MB, 0.044 ms at 3.35 TB/s.  The chain itself
// is cheap (3000 steps of a 4-cycle multiply and a 4-cycle add, ~12 us at
// 1.98 GHz), so the design is about keeping enough bytes in flight with few
// instructions: at B = 1 there are only W chains, and one thread per chain
// issuing its own loads (the first design) kept ~8 KB in flight per SM and
// read 31% of the byte bound.
//
// Design: one warp per block takes C = 32 channels of one batch row and
// streams its column of positions x C channels of a and bx through a ring of
// kStages shared-memory stages of 16 KB, filled with 16-byte ``cp.async``
// copies in commit groups.  Before it scans stage s the warp issues the
// copies of stage s + kStages - 1, so kStages - 1 stages (48 KB) are in
// flight while it computes.  Each lane's copies walk one pointer per array
// by whole positions, so a copy costs an add.  Lanes 0..C-1 then carry the
// chains through the stage: a batch of positions' a and bx from shared
// memory into registers (consecutive lanes, consecutive words: no bank
// conflicts), then multiply, add and a streaming (evict-first) store of h a
// position, one line of C floats.  A width that is not a multiple of 4
// floats, or a base that is not 16-byte aligned, takes the same ring with
// 4-byte copies.
//
// Measured by chip_smoke.py phase 3d on an NVIDIA H100 80GB HBM3 at
// 700.00 W: at [1, 3000, 4096] 0.0538-0.0540 ms (82% of the byte bound).
// 16-channel blocks (twice the blocks, 64-byte rows) took 0.0589-0.0592 ms
// there, so the kernel has the one width.
//
// A chunked two-pass scan would put more threads on each channel, but it
// changes the association order, so the result would no longer be bitwise
// the plain loop and the decode update (recurrentgemma's continuous ==
// sequential contract): it is not used.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int C = 32;  // channels of a block
constexpr int kStageBytes = 16384;  // a and bx of one stage
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int T = kStageBytes / (2 * C * 4);  // positions a stage
constexpr int kBatch = 16;  // positions loaded from the ring at once

template <bool kVec>
__global__ void __launch_bounds__(32)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  float* __restrict__ h, int s, int w) {
  constexpr int kRow = C / 4;   // 16-byte copies a position of one array
  constexpr int kP = 32 / kRow;  // positions one copy of the warp covers
  extern __shared__ float4 ring_raw[];
  float* ring = reinterpret_cast<float*>(ring_raw);
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * C;
  const long long row = (long long)blockIdx.y * s * w + c0;
  const int nst = (s + T - 1) / T;

  // This lane's copies: positions lp + j*kP, channels lch..lch+3 (16-byte
  // copies), or position p, channel lane (4-byte copies); one pointer per
  // array, stepped by whole positions, so a copy costs an add.
  const int lp = kVec ? lane / kRow : 0;
  const int lch = kVec ? (lane % kRow) * 4 : lane;
  const bool copier = kVec ? c0 + lch < w : lane < C && c0 + lane < w;
  const float* ga = a + row + (long long)lp * w + lch;
  const float* gb = bx + row + (long long)lp * w + lch;
  float* dcopy = ring + lp * C + lch;

  // stage st into ring slot st % kStages, as one commit group (empty past
  // the end, so the group count stays uniform)
  auto issue = [&](int st) {
    if (st < nst && copier) {
      float* da = dcopy + (st % kStages) * (2 * T * C);
      float* db = da + T * C;
      const long long off = (long long)st * T * w;
      const float* pa = ga + off;
      const float* pb = gb + off;
      const int n = s - st * T;  // positions left from this stage on
      if (kVec) {
        const long long step = (long long)kP * w;
        if (n >= T) {
#pragma unroll
          for (int j = 0; j < T / kP; ++j) {
            cp_async16(da + j * kP * C, pa, true);
            cp_async16(db + j * kP * C, pb, true);
            pa += step;
            pb += step;
          }
        } else {
          for (int j = 0; lp + j * kP < n; ++j) {
            cp_async16(da + j * kP * C, pa, true);
            cp_async16(db + j * kP * C, pb, true);
            pa += step;
            pb += step;
          }
        }
      } else {
        for (int p = 0; p < min(T, n); ++p) {
          cp_async4(da + p * C, pa);
          cp_async4(db + p * C, pb);
          pa += w;
          pb += w;
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  const bool live = lane < C && c0 + lane < w;
  const float* rd = ring + lane;
  float* hq = h + row + lane;
  float state = 0.f;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // stage st landed; stage st-1's slot is consumed
    issue(st + kStages - 1);
    const float* ra = rd + (st % kStages) * (2 * T * C);
    const float* rb = ra + T * C;
    const int n = min(T, s - st * T);
    if (live) {
      if (n == T) {
        // a batch of positions' a and bx into registers first: the
        // streaming store is a compiler barrier, so a load after it would
        // wait for it and put the shared-memory latency on the chain
#pragma unroll 1
        for (int p0 = 0; p0 < T; p0 += kBatch) {
          float av[kBatch], bv[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            av[i] = ra[(p0 + i) * C];
            bv[i] = rb[(p0 + i) * C];
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            state = __fadd_rn(__fmul_rn(av[i], state), bv[i]);
            __stcs(hq, state);
            hq += w;
          }
        }
      } else {
        for (int p = 0; p < n; ++p) {
          state = __fadd_rn(__fmul_rn(ra[p * C], state), rb[p * C]);
          __stcs(hq, state);
          hq += w;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kVec>
int launch(const float* a, const float* bx, float* h, int b, int s, int w,
           cudaStream_t stream) {
  const cudaError_t err =
      repro::allow_smem<rglru_scan_kernel<kVec>>(kRingBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + C - 1) / C, b);
  rglru_scan_kernel<kVec><<<grid, 32, kRingBytes, stream>>>(a, bx, h, s, w);
  return (int)cudaGetLastError();
}

}  // namespace

// a, bx -> h, each f32 [b, s, w] contiguous (the wrapper checks).
extern "C" int repro_rglru_scan(const void* a, const void* bx, void* h, int b,
                                int s, int w, void* stream) {
  if (b < 0 || s < 0 || w < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || w == 0) return (int)cudaGetLastError();
  const float* fa = (const float*)a;
  const float* fb = (const float*)bx;
  float* fh = (float*)h;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)bx % 16 == 0;
  return vec ? launch<true>(fa, fb, fh, b, s, w, st)
             : launch<false>(fa, fb, fh, b, s, w, st);
}

// The ring as compiled: stages, bytes a stage (a and bx), positions a stage
// and channels a block, into out[0..3].  A host query; launches nothing.
extern "C" int repro_rglru_scan_ring(int* out) {
  out[0] = kStages;
  out[1] = kStageBytes;
  out[2] = T;
  out[3] = C;
  return 0;
}
