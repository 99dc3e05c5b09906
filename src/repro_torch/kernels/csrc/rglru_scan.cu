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
// so the result is bitwise the plain step-by-step loop
// (kernels/ref.py rglru_scan_plain) and the per-token decode update
// (models/rglru.py rglru_decode: h * a + bx).
//
// What bounds it on an H100: bytes.  Two f32 inputs read once and one f32
// output written once, 12 B per element and one multiply-add: at
// [1, 3000, 4096] that is 147 MB, 0.044 ms at 3.35 TB/s.
// Design (the simple one): one thread per (batch row, channel), sequential
// over S with the state in a register.  Neighbouring threads hold
// neighbouring channels, so each load and store of a warp is one 128-byte
// line.  Parallelism is only B * W threads (4096 at B = 1), so the loads of
// kUnroll steps are all in flight before the first of them is used, to keep
// enough bytes moving; blocks are one warp wide, so the few warps spread
// over as many SMs as there are.  Loads and stores are streaming
// (evict-first): nothing is read twice.  A chunked two-pass scan, which
// would put every SM to work at B = 1, is later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 32;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  float* __restrict__ h, int s, int w) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const long long base = (long long)blockIdx.y * s * w + c;
  const float* ap = a + base;
  const float* bp = bx + base;
  float* hp = h + base;
  float state = 0.f;
  int t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long off = (long long)(t + i) * w;
      av[i] = __ldcs(ap + off);
      bv[i] = __ldcs(bp + off);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      state = __fadd_rn(__fmul_rn(av[i], state), bv[i]);
      __stcs(hp + (long long)(t + i) * w, state);
    }
  }
  for (; t < s; ++t) {
    const long long off = (long long)t * w;
    state = __fadd_rn(__fmul_rn(__ldcs(ap + off), state), __ldcs(bp + off));
    __stcs(hp + off, state);
  }
}

}  // namespace

// a, bx -> h, each f32 [b, s, w] contiguous (the wrapper checks).
extern "C" int repro_rglru_scan(const void* a, const void* bx, void* h, int b,
                                int s, int w, void* stream) {
  if (b > 0 && s > 0 && w > 0) {
    dim3 grid((w + kThreads - 1) / kThreads, b);
    rglru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)bx, (float*)h, s, w);
  }
  return (int)cudaGetLastError();
}
