// Flash-attention prefill for Hopper (sm_90a), fp32 route: the port of the
// TPU kernel ``flash_attention`` in src/repro/kernels/flash_attn.py (body
// ``_flash_kernel``).  This file now serves float32 only; bfloat16 (the
// serve path) runs on the tensor cores in flash_prefill_sm90.cu.  fp32 stays
// scalar because tensor cores would mean TF32, which the fp32 check (atol =
// rtol = 2e-5 against the plain version) rightly refuses.
//
// Computes, for every (batch*head) row block, causal or full online-softmax
// attention: scores in f32 scaled by dk^-0.5, masked entries at -1e30, a
// running (m, l, acc) in f32, l clamped at 1e-30, output in f32.
// GQA: query head ``bh`` reads kv head ``bh / groups`` straight from memory
// (never a repeated copy).
//
// Design.  One thread block per (bh, 64-row query tile); one thread per
// query row keeps its scaled q row, its f32 accumulator and (m, l) in
// registers.  The TPU kernel's sequential kv grid axis with scratch carried
// across steps becomes a loop inside the block: 32-row K/V tiles are staged
// through shared memory and every thread reads the same K/V element at a
// time, a broadcast.  The loop stops at the diagonal tile under causal
// masking, and the ragged last query tile and key tile are masked in the
// kernel, so no length has to be a multiple of a tile.
//
// Bound.  The work is ~4*BH*D*L^2/2 FLOPs against 4*BH*L*D*4 bytes; on
// scalar f32 FMAs (67 TFLOP/s peak) it is compute-bound far above the byte
// bound.  Only the fp32 smoke configurations reach it.
#include "common.cuh"

namespace repro {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int Sq, int Sk, int groups, int causal,
                     long long q_sbh, long long q_ss, long long k_sbh,
                     long long k_ss, long long v_sbh, long long v_ss,
                     long long o_sbh, long long o_ss, float scale) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int t = threadIdx.x;
  const int row = q0 + t;
  const bool live = row < Sq;
  const int kvh = bh / groups;
  const T* kp = k + kvh * k_sbh;
  const T* vp = v + kvh * v_sbh;

  float qr[D];
  float acc[D];
  if (live) {
    const T* qp = q + bh * q_sbh + (long long)row * q_ss;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qp[d]) * scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = t; e < BK * D; e += BQ) {
      const int r = e / D;
      const int c = e - r * D;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < Sk) {
        kv = to_f32(kp[(long long)kr * k_ss + c]);
        vv = to_f32(vp[(long long)kr * v_ss + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kr = k0 + j;
      const bool ok = live && kr < Sk && (!causal || kr <= row);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = ok ? dot : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kr = k0 + j;
      const bool ok = live && kr < Sk && (!causal || kr <= row);
      s[j] = ok ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) a = fmaf(s[j], vs[j][d], a);
      acc[d] = a;
    }
    m = m_new;
  }

  if (live) {
    const float lc = fmaxf(l, 1e-30f);
    T* op = o + bh * o_sbh + (long long)row * o_ss;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] / lc);
  }
}

template <typename T, int D>
static void launch_prefill(const void* q, const void* k, const void* v,
                           void* o, int BH, int Sq, int Sk, int groups,
                           int causal, long long q_sbh, long long q_ss,
                           long long k_sbh, long long k_ss, long long v_sbh,
                           long long v_ss, long long o_sbh, long long o_ss,
                           float scale, cudaStream_t stream) {
  constexpr int BQ = 64;
  constexpr int BK = 32;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_prefill_kernel<T, D, BQ, BK><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, groups, causal,
      q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss, scale);
}

}  // namespace repro

// float32, head dim 64 only (that of every configuration served).
extern "C" int repro_flash_prefill(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int BH, int Sq,
                                   int Sk, int D, int groups, int causal,
                                   long long q_sbh, long long q_ss,
                                   long long k_sbh, long long k_ss,
                                   long long v_sbh, long long v_ss,
                                   long long o_sbh, long long o_ss,
                                   float scale, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PREFILL(T, DD)                                                 \
  launch_prefill<T, DD>(q, k, v, o, BH, Sq, Sk, groups, causal, q_sbh, q_ss, \
                        k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss, scale, st)
  if (dtype == kFloat32 && D == 64) {
    REPRO_PREFILL(float, 64);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PREFILL
  return static_cast<int>(cudaGetLastError());
}
