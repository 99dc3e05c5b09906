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
