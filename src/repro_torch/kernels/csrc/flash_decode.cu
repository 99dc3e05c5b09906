// Flash-decode step for Hopper (sm_90a): the port of ``flash_decode_step``
// in src/repro/kernels/flash_attn.py.  In the JAX package that step is a
// ``lax.scan`` over 128-wide KV blocks rather than a ``pallas_call``; it
// runs once per layer per generated token on the serve path.
//
// One query row per (slot, head) attends to its slot's cached keys
// ``[0, pos[slot]]``: f32 online softmax over 128-wide KV blocks, scores
// scaled by dk^-0.5, l clamped at 1e-30, output in the input type.  ``pos``
// is an int32 device vector, one entry per slot, so the host never syncs to
// learn a position.  The cache is read in its stored layout
// ``[S, max_seq, kv, hd]`` through strides (no transposed copy), and query
// head ``h`` of a slot reads kv head ``h / groups`` (GQA without a repeat).
//
// Design.  One block of 128 threads per (slot, head).  The loop visits KV
// blocks up to pos[slot] only: skipping a fully masked block is exact,
// because a block of -1e30 scores leaves (m, l, acc) unchanged.  Each
// block's keys are staged through shared memory (row-padded to dodge bank
// conflicts), one thread scores one key, block-wide max/sum reductions
// update (m, l), then the values are staged through the same buffer and
// thread d accumulates output element d.
//
// Bound.  Decode attention reads each valid cache row once: per layer per
// tick sum_slots (pos+1) * kv * hd * 2 (K and V) * 2 bytes against ~4 FLOPs
// per byte, so the card's memory rate (3.35 TB/s) bounds it.  This first
// version keeps one block per (slot, head) with no split over the KV axis,
// so short batches leave most SMs idle; split-KV is later work.
#include "common.cuh"

namespace repro {

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ o, int H, int groups, int Smax,
                    long long q_sr, long long k_sslot, long long k_sseq,
                    long long k_sh, long long v_sslot, long long v_sseq,
                    long long v_sh, long long o_sr, float scale) {
  constexpr int NT = 128;
  constexpr int BK = 128;
  __shared__ float kvs[BK][D + 1];
  __shared__ float qs[D];
  __shared__ float ps[BK];
  __shared__ float red[NT / 32];

  const int r = blockIdx.x;  // slot * H + head
  const int slot = r / H;
  const int head = r - slot * H;
  const int kvh = head / groups;
  const int t = threadIdx.x;
  // keys [0, pos] are valid; a position past the cache attends to all of it
  const int n = min(max(pos[slot], 0), Smax - 1) + 1;

  const T* qp = q + r * q_sr;
  for (int d = t; d < D; d += NT) qs[d] = to_f32(qp[d]) * scale;
  const T* kb = k + slot * k_sslot + kvh * k_sh;
  const T* vb = v + slot * v_sslot + kvh * v_sh;

  float m = kNegInf;
  float l = 0.f;
  float acc = 0.f;  // thread t < D owns output element t
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // qs written / previous V block consumed
    for (int e = t; e < BK * D; e += NT) {
      const int rr = e / D;
      const int c = e - rr * D;
      const int kr = k0 + rr;
      kvs[rr][c] = kr < n ? to_f32(kb[(long long)kr * k_sseq + c]) : 0.f;
    }
    __syncthreads();

    const bool ok = k0 + t < n;
    float s = kNegInf;
    if (ok) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qs[d], kvs[t][d], dot);
      s = dot;
    }
    const float m_new = fmaxf(m, block_max<NT>(s, red));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    ps[t] = p;
    l = l * alpha + block_sum<NT>(p, red);  // its barriers also publish ps

    for (int e = t; e < BK * D; e += NT) {
      const int rr = e / D;
      const int c = e - rr * D;
      const int kr = k0 + rr;
      kvs[rr][c] = kr < n ? to_f32(vb[(long long)kr * v_sseq + c]) : 0.f;
    }
    __syncthreads();
    if (t < D) {
      const int jn = min(BK, n - k0);
      float a = acc * alpha;
      for (int j = 0; j < jn; ++j) a = fmaf(ps[j], kvs[j][t], a);
      acc = a;
    }
    m = m_new;
  }
  if (t < D) o[r * o_sr + t] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
static void launch_decode(const void* q, const void* k, const void* v,
                          const int* pos, void* o, int S, int H, int groups,
                          int Smax, long long q_sr, long long k_sslot,
                          long long k_sseq, long long k_sh, long long v_sslot,
                          long long v_sseq, long long v_sh, long long o_sr,
                          float scale, cudaStream_t stream) {
  flash_decode_kernel<T, D><<<S * H, 128, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), H, groups, Smax,
      q_sr, k_sslot, k_sseq, k_sh, v_sslot, v_sseq, v_sh, o_sr, scale);
}

}  // namespace repro

// Instantiated for head dim 64 only, that of every configuration served.
extern "C" int repro_flash_decode(int dtype, const void* q, const void* k,
                                  const void* v, const void* pos, void* o,
                                  int S, int H, int D, int groups, int Smax,
                                  long long q_sr, long long k_sslot,
                                  long long k_sseq, long long k_sh,
                                  long long v_sslot, long long v_sseq,
                                  long long v_sh, long long o_sr, float scale,
                                  void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
#define REPRO_DECODE(T, DD)                                                \
  launch_decode<T, DD>(q, k, v, p, o, S, H, groups, Smax, q_sr, k_sslot,   \
                       k_sseq, k_sh, v_sslot, v_sseq, v_sh, o_sr, scale, st)
  if (dtype == kFloat32 && D == 64) {
    REPRO_DECODE(float, 64);
  } else if (dtype == kBFloat16 && D == 64) {
    REPRO_DECODE(__nv_bfloat16, 64);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE
  return static_cast<int>(cudaGetLastError());
}
