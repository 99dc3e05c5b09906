// The SSD inter-chunk state recurrence of Mamba-2 (kernel S2):
//
//     h_starts[c] = h_c,   h_{c+1} = h_c * decay_c + S_c,   h_0 = h0 (or 0)
//
// A new kernel, not a TPU port: the JAX package runs this recurrence as a
// jax.lax.scan over chunks (src/repro/models/ssm.py _ssd_scan, :115-123),
// which XLA lowers to a loop of fused elementwise steps.  torch has no
// counterpart, and a Python loop would launch two small ops a chunk in
// every SSD layer (~32 launches a layer for a 2048-token prompt at chunk
// 128).  The chunk-local products around it (G, y_intra, S_c, y_inter)
// stay torch.einsum, as the reference leaves them to XLA.
//
// Contract: decay f32 [B, nc, H]; states (S_c) f32 [B, nc, H, N, hd]; h0
// f32 [B, H, N, hd] or null (zeros); h_starts f32 [B, nc, H, N, hd]; h_final
// f32 [B, H, N, hd]; all contiguous.  Each step is an IEEE multiply then an
// IEEE add (__fmul_rn / __fadd_rn, never an FMA), in chunk order, one chain
// per (b, h, n, d) element, so the result is bitwise the plain loop
// (kernels/ref.py ssd_state_scan_plain).  An element's bits depend on its
// own chain only: not on B or the grid.
//
// What bounds it on an H100: bytes.  S_c read once, h_starts written once,
// h_final written once (h0 read once when given): at mamba2-130m's 2048-
// token prompt, [1, 16, 24, 128, 64], that is 26 MB, 7.8 us at 3.35 TB/s.
// The chains are short (nc steps of a multiply and an add), so the design
// only has to keep loads in flight: one thread carries four neighbouring
// elements as a float4 (16-byte loads and stores, four independent
// chains), and the loop over chunks is unrolled so the loads of later
// chunks issue before the earlier chunks' arithmetic, which is all that
// depends on them.  A width N*hd that is not a multiple of 4, or a base
// that is not 16-byte aligned, takes the same loop one float at a time.
//
// The backward (ssd_state_scan_bwd_kernel, entry repro_ssd_state_scan_bwd)
// runs the recurrence's adjoint from the last chunk: gh_nc = G_final,
// then for c = nc-1 .. 0
//
//     d_states_c = gh_{c+1},   d_decay_c = sum_{n,d} gh_{c+1} * h_c,
//     gh_c = G_starts_c + decay_c * gh_{c+1}   (a multiply then an add),
//
// and d_h0 = gh_0, reading the forward's saved h_starts (h_c).  A null
// G_starts or G_final reads as zeros (autograd passes no gradient for
// h_final in training).  d_states and d_h0 are bitwise the plain loop
// (kernels/ref.py ssd_state_scan_bwd_plain).  d_decay_c is a reduction
// over N*hd elements of each (b, c, h): each thread sums its four products
// in order, a warp combines its lanes by an xor butterfly (every lane ends
// with the same bits), each warp writes its partial, and a second small
// kernel sums a row's partials in index order.  No atomics, so a row's
// bits depend on its own inputs only, not on B, the grid or the run; the
// plain version sums in torch's order, so d_decay agrees with it within
// f32 rounding of the sum.  Bytes bound it: h_starts and G_starts read and
// d_states written, 12 B an element; at mamba2-130m's batch 8 of 2048
// tokens, [8, 16, 24, 128, 64], 302 MB, 0.090 ms at 3.35 TB/s.  The
// chains and their float4 layout are the forward's, walked from the end.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_state_scan_kernel(const float* __restrict__ decay,
                      const float* __restrict__ states,
                      const float* __restrict__ h0,
                      float* __restrict__ h_starts,
                      float* __restrict__ h_final, int nc, int nh, int ne) {
  constexpr int kW = kVec ? 4 : 1;  // elements a thread carries
  const int bh = blockIdx.x;        // b * nh + h
  const int b = bh / nh;
  const int h = bh % nh;
  const int e = (blockIdx.y * kThreads + threadIdx.x) * kW;
  if (e >= ne) return;
  const long long chunk = (long long)nh * ne;  // states: chunk c to c + 1
  const long long base = ((long long)b * nc * nh + h) * ne + e;
  const float* dec = decay + (long long)b * nc * nh + h;  // [c * nh]
  const long long hoff = (long long)bh * ne + e;
  if (kVec) {
    float4 st = h0 ? *reinterpret_cast<const float4*>(h0 + hoff)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const long long off = base + c * chunk;
      const float4 s = __ldcs(reinterpret_cast<const float4*>(states + off));
      const float d = __ldg(dec + (long long)c * nh);
      *reinterpret_cast<float4*>(h_starts + off) = st;
      st.x = __fadd_rn(__fmul_rn(st.x, d), s.x);
      st.y = __fadd_rn(__fmul_rn(st.y, d), s.y);
      st.z = __fadd_rn(__fmul_rn(st.z, d), s.z);
      st.w = __fadd_rn(__fmul_rn(st.w, d), s.w);
    }
    *reinterpret_cast<float4*>(h_final + hoff) = st;
  } else {
    float st = h0 ? h0[hoff] : 0.f;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const long long off = base + c * chunk;
      const float s = __ldcs(states + off);
      const float d = __ldg(dec + (long long)c * nh);
      h_starts[off] = st;
      st = __fadd_rn(__fmul_rn(st, d), s);
    }
    h_final[hoff] = st;
  }
}

template <bool kVec>
int launch(const float* decay, const float* states, const float* h0,
           float* h_starts, float* h_final, int b, int nc, int nh, int ne,
           cudaStream_t stream) {
  constexpr int kW = kVec ? 4 : 1;
  const long long per_block = (long long)kThreads * kW;
  const long long gy = (ne + per_block - 1) / per_block;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(b * nh, (unsigned)gy);
  ssd_state_scan_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      decay, states, h0, h_starts, h_final, nc, nh, ne);
  return (int)cudaGetLastError();
}

// Backward chains: block (bh, y) takes elements [e0, e0 + kThreads * kW) of
// row bh; each warp writes its partial of d_decay_c to
// partial[(b * nc + c) * nh + h][y * kWarps + warp].
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_state_scan_bwd_kernel(const float* __restrict__ decay,
                          const float* __restrict__ h_starts,
                          const float* __restrict__ g_starts,
                          const float* __restrict__ g_final,
                          float* __restrict__ d_states,
                          float* __restrict__ d_h0,
                          float* __restrict__ partial, int nc, int nh, int ne,
                          int cap) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kWarps = kThreads / 32;
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh % nh;
  const int warp = threadIdx.x / 32;
  const int e = (blockIdx.y * kThreads + threadIdx.x) * kW;
  const bool in = e < ne;  // out-of-range lanes still join the shuffles
  const long long chunk = (long long)nh * ne;
  const long long base = ((long long)b * nc * nh + h) * ne + e;
  const float* dec = decay + (long long)b * nc * nh + h;
  const long long hoff = (long long)bh * ne + e;
  const int slot = blockIdx.y * kWarps + warp;
  float* part = partial + ((long long)b * nc * nh + h) * cap + slot;
  const long long pstep = (long long)nh * cap;  // partial: chunk c to c + 1
  float g[kW], hs[kW], gs[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) g[i] = 0.f;
  if (in && g_final) {
    if (kVec) {
      const float4 v = *reinterpret_cast<const float4*>(g_final + hoff);
      g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
    } else {
      g[0] = g_final[hoff];
    }
  }
#pragma unroll 4
  for (int c = nc - 1; c >= 0; --c) {
    const long long off = base + c * chunk;
#pragma unroll
    for (int i = 0; i < kW; ++i) hs[i] = gs[i] = 0.f;
    if (in) {
      if (kVec) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(h_starts + off));
        hs[0] = v.x; hs[1] = v.y; hs[2] = v.z; hs[3] = v.w;
        if (g_starts) {
          const float4 u =
              __ldcs(reinterpret_cast<const float4*>(g_starts + off));
          gs[0] = u.x; gs[1] = u.y; gs[2] = u.z; gs[3] = u.w;
        }
        __stcs(reinterpret_cast<float4*>(d_states + off),
               make_float4(g[0], g[1], g[2], g[3]));
      } else {
        hs[0] = __ldcs(h_starts + off);
        if (g_starts) gs[0] = __ldcs(g_starts + off);
        __stcs(d_states + off, g[0]);
      }
    }
    const float d = __ldg(dec + (long long)c * nh);
    float sum = __fmul_rn(g[0], hs[0]);
#pragma unroll
    for (int i = 1; i < kW; ++i) sum = __fadd_rn(sum, __fmul_rn(g[i], hs[i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    if ((threadIdx.x & 31) == 0) part[c * pstep] = sum;
#pragma unroll
    for (int i = 0; i < kW; ++i) g[i] = __fadd_rn(gs[i], __fmul_rn(d, g[i]));
  }
  if (in && d_h0) {
    if (kVec)
      *reinterpret_cast<float4*>(d_h0 + hoff) =
          make_float4(g[0], g[1], g[2], g[3]);
    else
      d_h0[hoff] = g[0];
  }
}

// d_decay[r] = the partials of row r summed in index order.
__global__ void __launch_bounds__(kThreads)
ssd_decay_grad_kernel(const float* __restrict__ partial,
                      float* __restrict__ d_decay, int rows, int parts,
                      int cap) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + (long long)r * cap;
  float s = p[0];
  for (int i = 1; i < parts; ++i) s = __fadd_rn(s, p[i]);
  d_decay[r] = s;
}

template <bool kVec>
int launch_bwd(const float* decay, const float* h_starts,
               const float* g_starts, const float* g_final, float* d_states,
               float* d_h0, float* partial, float* d_decay, int b, int nc,
               int nh, int ne, int cap, cudaStream_t stream) {
  constexpr int kW = kVec ? 4 : 1;
  const long long per_block = (long long)kThreads * kW;
  const long long gy = (ne + per_block - 1) / per_block;
  const long long parts = gy * (kThreads / 32);
  if (gy > 65535 || parts > cap) return (int)cudaErrorInvalidValue;
  dim3 grid(b * nh, (unsigned)gy);
  ssd_state_scan_bwd_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      decay, h_starts, g_starts, g_final, d_states, d_h0, partial, nc, nh,
      ne, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = b * nc * nh;
  if (rows > 0) {
    ssd_decay_grad_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(partial, d_decay, rows, (int)parts,
                                      cap);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// decay, states, h0 (may be null) -> h_starts, h_final; ne = N * hd.  Shapes
// and contiguity are the wrapper's checks (kernels/ssd_scan.py).
extern "C" int repro_ssd_state_scan(const void* decay, const void* states,
                                    const void* h0, void* h_starts,
                                    void* h_final, int b, int nc, int nh,
                                    int ne, void* stream) {
  if (b < 0 || nc < 0 || nh < 0 || ne < 0 ||
      (long long)b * nh > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || nh == 0 || ne == 0) return (int)cudaGetLastError();
  const float* fd = (const float*)decay;
  const float* fs = (const float*)states;
  const float* f0 = (const float*)h0;
  float* fh = (float*)h_starts;
  float* ff = (float*)h_final;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = ne % 4 == 0 && aligned16(fs) && aligned16(fh) &&
                   aligned16(ff) && (f0 == nullptr || aligned16(f0));
  return vec ? launch<true>(fd, fs, f0, fh, ff, b, nc, nh, ne, st)
             : launch<false>(fd, fs, f0, fh, ff, b, nc, nh, ne, st);
}

// decay, h_starts and the gradients of h_starts and h_final (either may be
// null: zeros) -> d_states, d_h0 (null: not wanted) and d_decay, through
// ``partial``, a scratch of b*nc*nh rows of ``cap`` floats (at least the
// warps a row's elements span).  ne = N * hd.  Shapes and contiguity are
// the wrapper's checks (kernels/ssd_scan.py).
extern "C" int repro_ssd_state_scan_bwd(const void* decay, const void* h_starts,
                                        const void* g_starts,
                                        const void* g_final, void* d_states,
                                        void* d_h0, void* partial,
                                        void* d_decay, int b, int nc, int nh,
                                        int ne, int cap, void* stream) {
  if (b < 0 || nc < 0 || nh < 0 || ne < 0 || cap < 1 ||
      (long long)b * nh > 2147483647LL ||
      (long long)b * nc * nh > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || nh == 0 || ne == 0) return (int)cudaGetLastError();
  const float* fd = (const float*)decay;
  const float* fh = (const float*)h_starts;
  const float* fg = (const float*)g_starts;
  const float* ff = (const float*)g_final;
  float* fs = (float*)d_states;
  float* f0 = (float*)d_h0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = ne % 4 == 0 && aligned16(fh) && aligned16(fs) &&
                   (fg == nullptr || aligned16(fg)) &&
                   (ff == nullptr || aligned16(ff)) &&
                   (f0 == nullptr || aligned16(f0));
  return vec ? launch_bwd<true>(fd, fh, fg, ff, fs, f0, (float*)partial,
                                (float*)d_decay, b, nc, nh, ne, cap, st)
             : launch_bwd<false>(fd, fh, fg, ff, fs, f0, (float*)partial,
                                 (float*)d_decay, b, nc, nh, ne, cap, st);
}
