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
//
// The backward (rglru_scan_bwd_kernel, entry repro_rglru_scan_bwd) is the
// same recurrence run from the end: from g_S = 0, g_t = gh_t + a_{t+1}
// g_{t+1} (a multiply then an add), d_bx_t = g_t and d_a_t = g_t h_{t-1}
// with h_{-1} = 0, reading the forward's saved output h rather than
// recomputing it.  It is bitwise its plain loop (kernels/ref.py
// rglru_scan_bwd_plain).  The JAX package differentiates its
// associative_scan instead, so the two agree within f32 rounding.  Bytes
// bound it too: a, h and gh read once, d_a and d_bx written once, 20 B an
// element; at [2, 2048, 4096] (recurrentgemma-9b's width at batch 2) that
// is 336 MB, 0.100 ms at 3.35 TB/s.  Its design is the forward's walked
// backwards: one warp a block over C channels, a ring of kStages stages
// of T positions holding a, h and gh (24 KB a stage, 96 KB a block, so
// two blocks an SM keep 144 KB in flight), filled by cp.async from the
// last stage down.  h_{t-1} of a stage's first position lies in the stage
// after it in the walk, so d_a_t is written one step late, when the walk
// reaches position t - 1 and reads h_{t-1}; d_a_0 = g_0 * 0 after the
// loop.
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
// the backward's ring: a, h and gh of T positions a stage
constexpr int kBwdStageBytes = 3 * T * C * 4;
constexpr int kBwdRingBytes = kStages * kBwdStageBytes;

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

// Backward: a, h, gh -> d_a, d_bx, each f32 [B, S, W].  Block (x, y) takes
// channels [x*C, x*C + C) of row y; stage k of the walk is sequence stage
// nst - 1 - k.
template <bool kVec>
__global__ void __launch_bounds__(32)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ gh, float* __restrict__ d_a,
                      float* __restrict__ d_bx, int s, int w) {
  constexpr int kRow = C / 4;
  constexpr int kP = 32 / kRow;
  extern __shared__ float4 ring_raw[];
  float* ring = reinterpret_cast<float*>(ring_raw);
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * C;
  const long long row = (long long)blockIdx.y * s * w + c0;
  const int nst = (s + T - 1) / T;

  const int lp = kVec ? lane / kRow : 0;
  const int lch = kVec ? (lane % kRow) * 4 : lane;
  const bool copier = kVec ? c0 + lch < w : lane < C && c0 + lane < w;
  const long long lo = row + (long long)lp * w + lch;
  float* dcopy = ring + lp * C + lch;

  // the walk's k-th stage into ring slot k % kStages, as one commit group
  auto issue = [&](int k) {
    if (k < nst && copier) {
      const int st = nst - 1 - k;
      float* dst[3];
      dst[0] = dcopy + (k % kStages) * (3 * T * C);
      dst[1] = dst[0] + T * C;
      dst[2] = dst[1] + T * C;
      const long long off = lo + (long long)st * T * w;
      const float* src[3] = {a + off, h + off, gh + off};
      const int n = min(T, s - st * T);
      if (kVec) {
        const long long step = (long long)kP * w;
        for (int j = 0; lp + j * kP < n; ++j) {
#pragma unroll
          for (int r = 0; r < 3; ++r)
            cp_async16(dst[r] + j * kP * C, src[r] + j * step, true);
        }
      } else {
        for (int p = 0; p < n; ++p) {
#pragma unroll
          for (int r = 0; r < 3; ++r)
            cp_async4(dst[r] + p * C, src[r] + (long long)p * w);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  const bool live = lane < C && c0 + lane < w;
  const float* rd = ring + lane;
  float* qa = d_a + row + lane;
  float* qb = d_bx + row + lane;
  float g = 0.f;       // g_{t+1} on entry to position t
  float a_next = 0.f;  // a_{t+1}
  for (int k = 0; k < nst; ++k) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // stage k landed; stage k-1's slot is consumed
    issue(k + kStages - 1);
    const int st = nst - 1 - k;
    const float* ra = rd + (k % kStages) * (3 * T * C);
    const float* rh = ra + T * C;
    const float* rg = rh + T * C;
    const int n = min(T, s - st * T);
    const long long t0 = (long long)st * T;
    if (live) {
      if (n == T) {
#pragma unroll 1
        for (int p0 = T - kBatch; p0 >= 0; p0 -= kBatch) {
          float av[kBatch], hv[kBatch], gv[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            av[i] = ra[(p0 + i) * C];
            hv[i] = rh[(p0 + i) * C];
            gv[i] = rg[(p0 + i) * C];
          }
#pragma unroll
          for (int i = kBatch - 1; i >= 0; --i) {
            const long long t = t0 + p0 + i;
            if (t + 1 < s) __stcs(qa + (t + 1) * w, __fmul_rn(g, hv[i]));
            g = __fadd_rn(__fmul_rn(a_next, g), gv[i]);
            __stcs(qb + t * w, g);
            a_next = av[i];
          }
        }
      } else {
        for (int p = n - 1; p >= 0; --p) {
          const long long t = t0 + p;
          if (t + 1 < s) __stcs(qa + (t + 1) * w, __fmul_rn(g, rh[p * C]));
          g = __fadd_rn(__fmul_rn(a_next, g), rg[p * C]);
          __stcs(qb + t * w, g);
          a_next = ra[p * C];
        }
      }
    }
  }
  if (live && s > 0) __stcs(qa, __fmul_rn(g, 0.f));  // d_a_0 = g_0 h_{-1}
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

template <bool kVec>
int launch_bwd(const float* a, const float* h, const float* gh, float* d_a,
               float* d_bx, int b, int s, int w, cudaStream_t stream) {
  const cudaError_t err =
      repro::allow_smem<rglru_scan_bwd_kernel<kVec>>(kBwdRingBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + C - 1) / C, b);
  rglru_scan_bwd_kernel<kVec><<<grid, 32, kBwdRingBytes, stream>>>(
      a, h, gh, d_a, d_bx, s, w);
  return (int)cudaGetLastError();
}

// a, h (the forward's output), gh (its gradient) -> d_a, d_bx, each f32
// [b, s, w] contiguous (the wrapper checks).
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* gh, void* d_a, void* d_bx,
                                    int b, int s, int w, void* stream) {
  if (b < 0 || s < 0 || w < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || w == 0) return (int)cudaGetLastError();
  const float* fa = (const float*)a;
  const float* fh = (const float*)h;
  const float* fg = (const float*)gh;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)h % 16 == 0 && (uintptr_t)gh % 16 == 0;
  return vec ? launch_bwd<true>(fa, fh, fg, (float*)d_a, (float*)d_bx, b, s,
                                w, st)
             : launch_bwd<false>(fa, fh, fg, (float*)d_a, (float*)d_bx, b, s,
                                 w, st);
}

// The ring as compiled: stages, bytes a forward stage (a and bx), positions
// a stage, channels a block and bytes a backward stage (a, h and gh), into
// out[0..4].  A host query; launches nothing.
extern "C" int repro_rglru_scan_ring(int* out) {
  out[0] = kStages;
  out[1] = kStageBytes;
  out[2] = T;
  out[3] = C;
  out[4] = kBwdStageBytes;
  return 0;
}
