// Flash-decode step for Hopper (sm_90a): the port of ``flash_decode_step``
// in src/repro/kernels/flash_attn.py.  In the JAX package that step is a
// ``lax.scan`` over 128-wide KV blocks rather than a ``pallas_call``; it
// runs once per layer per generated token on the serve path.
//
// One query row per (slot, head) attends to its slot's cached keys
// ``[0, pos[slot]]``: f32 online softmax, scores scaled by dk^-0.5, l
// clamped at 1e-30, output in the input type.  ``pos`` is an int32 device
// vector, one entry per slot, so the host never syncs to learn a position.
// The cache is read in its stored layout ``[S, max_seq, kv, hd]`` through
// strides (no transposed copy), and query head ``h`` of a slot reads kv
// head ``h / groups`` (GQA without a repeat).
//
// Design: split-KV (flash-decoding), two launches.
//   Pass 1, grid (S*H, NSPLIT): block (row, c) takes keys [128c, 128c+128)
// of its row.  NSPLIT = ceil(max_seq / 128) comes from shapes alone, so the
// host never reads ``pos``; a block whose chunk starts at or past
// n = min(max(pos, 0), max_seq - 1) + 1 writes the neutral partial
// (m = -1e30, l = 0, acc = 0) and returns.  Each lane loads 16 bytes (8
// bf16 or f32 values), so D/8 lanes cover a key row: 8 at head dim 64, 16
// at 128, 32 at 256, and a thread takes 8, 16 or 32 of the block's 128
// keys.  At 64 all 8 of its K and V rows are in flight before the first
// score; at 128 and 256 its rows load in chunks of 8 (the scores of all of
// them stay in registers).  A dot product ends in log2(D/8) shuffles
// inside its lane group, then a block max and a block sum.  For PV each
// thread sums 8 output elements over its keys, then the groups of a warp
// by shuffles and the 4 warps through shared memory, in a fixed order.  The
// partial (m, l, acc[D]) goes to an f32 scratch [S*H, NSPLIT, D + 2] that
// the wrapper allocates.
//   Pass 2, one block of D threads per row, combines the splits in order
// 0..NSPLIT-1: m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i
// e^(m_i - m) / max(l, 1e-30).  No float atomics: the result depends on the
// shapes and ``pos`` only, so a slot decodes bitwise alike in any batch.
//
// Bound.  Decode attention reads each valid cache row once: per layer per
// tick sum_slots (pos+1) * kv * hd * 2 (K and V) * 2 bytes against ~4 FLOPs
// per byte, so the card's memory rate (3.35 TB/s) bounds it.  Scalar f32
// arithmetic suffices here: each query row reads its K/V rows alone.  It
// runs head dim 64 (bf16 and f32) and f32 at 128 and 256 where a group has
// one or two query rows; the rest of 128 and 256, where a group's query
// rows share every K/V row, runs flash_decode_gqa.cu.
#include "common.cuh"

namespace repro {

constexpr int kDecodeSplit = 128;  // keys per pass-1 block (DECODE_SPLIT)
constexpr int kDecodeThreads = 128;

// 16-byte words per 8 elements: one for bf16, two for f32
template <typename T>
constexpr int kWords = sizeof(T) / 2;

template <typename T>
__device__ __forceinline__ void load8(const T* p, uint4 (&w)[kWords<T>]) {
#pragma unroll
  for (int i = 0; i < kWords<T>; ++i)
    w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

__device__ __forceinline__ void widen8(const uint4 (&w)[1], float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen8(const uint4 (&w)[2], float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(&w[i]);
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ pos,
                            float* __restrict__ part, int H, int groups,
                            int Smax, int nsplit, long long q_sr,
                            long long k_sslot, long long k_sseq,
                            long long k_sh, long long v_sslot,
                            long long v_sseq, long long v_sh, float scale) {
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64/128/256");
  constexpr int LANES = D / 8;     // lanes of 8 elements that cover a key row
  constexpr int GPW = 32 / LANES;  // keys of a warp in one step
  constexpr int NW = kDecodeThreads / 32;
  constexpr int STEP = GPW * NW;   // keys of the block in one step
  constexpr int KEYS = kDecodeSplit / STEP;  // per thread: 8, 16 or 32
  constexpr int CHUNK = KEYS < 8 ? KEYS : 8;  // rows a thread has in flight
  constexpr int W = kWords<T>;
  __shared__ float red_max[NW];
  __shared__ float red_sum[NW];
  __shared__ float red_acc[NW][D];

  const int r = blockIdx.x;  // slot * H + head
  const int split = blockIdx.y;
  const int slot = r / H;
  const int head = r - slot * H;
  const int kvh = head / groups;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane / LANES;  // key of the warp's GPW in one step
  const int sub = lane % LANES;  // owns elements [8*sub, 8*sub + 8)
  // keys [0, pos] are valid; a position past the cache attends to all of it
  const int n = min(max(pos[slot], 0), Smax - 1) + 1;
  const int c0 = split * kDecodeSplit;
  float* out = part + (static_cast<long long>(r) * nsplit + split) * (D + 2);
  if (c0 >= n) {  // no valid key here: the neutral partial
    for (int i = t; i < D + 2; i += kDecodeThreads)
      out[i] = i == 0 ? kNegInf : 0.f;
    return;
  }

  // key of step i: c0 + STEP*i + GPW*warp + grp.  The first CHUNK K and V
  // rows are all in flight before the first score (at D = 64 that is
  // every row of the thread); later chunks load as they are reached.
  const T* kb = k + slot * k_sslot + kvh * k_sh + 8 * sub;
  const T* vb = v + slot * v_sslot + kvh * v_sh + 8 * sub;
  uint4 kw[CHUNK][W], vw[CHUNK][W];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int key = c0 + STEP * j + GPW * warp + grp;
    if (key < n) {
      load8(kb + key * k_sseq, kw[j]);
      load8(vb + key * v_sseq, vw[j]);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) kw[j][w] = vw[j][w] = make_uint4(0, 0, 0, 0);
    }
  }
  float qv[8];
  const T* qp = q + r * q_sr + 8 * sub;
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = to_f32(qp[e]) * scale;

  float s[KEYS];
  float mx = kNegInf;
#pragma unroll
  for (int c = 0; c < KEYS / CHUNK; ++c) {
    if (c > 0) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int key = c0 + STEP * (c * CHUNK + j) + GPW * warp + grp;
        if (key < n) {
          load8(kb + key * k_sseq, kw[j]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) kw[j][w] = make_uint4(0, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = c * CHUNK + j;
      float x[8];
      widen8(kw[j], x);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qv[e], x[e], dot);
      // a butterfly: all LANES lanes of the group end with the same sum
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int key = c0 + STEP * i + GPW * warp + grp;
      s[i] = key < n ? dot : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
  }
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red_max[warp] = mx;
  __syncthreads();
  float m = red_max[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red_max[w]);

  float lsum = 0.f;  // the group's keys, counted once per lane of the group
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int c = 0; c < KEYS / CHUNK; ++c) {
    if (c > 0) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int key = c0 + STEP * (c * CHUNK + j) + GPW * warp + grp;
        if (key < n) {
          load8(vb + key * v_sseq, vw[j]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) vw[j][w] = make_uint4(0, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = c * CHUNK + j;
      const int key = c0 + STEP * i + GPW * warp + grp;
      const float p = key < n ? expf(s[i] - m) : 0.f;
      lsum += p;
      float x[8];
      widen8(vw[j], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, x[e], acc[e]);
    }
  }
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
    lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane == 0) red_sum[warp] = lsum;
  if (lane < LANES) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red_acc[warp][8 * lane + e] = acc[e];
  }
  __syncthreads();
  for (int d = t; d < D; d += kDecodeThreads) {
    float a = red_acc[0][d];
#pragma unroll
    for (int w = 1; w < NW; ++w) a += red_acc[w][d];
    out[2 + d] = a;
  }
  if (t == 0) {
    float l = red_sum[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) l += red_sum[w];
    out[0] = m;
    out[1] = l;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ part,
                            T* __restrict__ o, int nsplit, long long o_sr) {
  const int r = blockIdx.x;
  const int d = threadIdx.x;
  const float* pr = part + static_cast<long long>(r) * nsplit * (D + 2);
  float m = kNegInf;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, pr[i * (D + 2)]);
  float l = 0.f;
  float a = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float* pi = pr + i * (D + 2);
    const float e = expf(pi[0] - m);
    l += pi[1] * e;
    a += pi[2 + d] * e;
  }
  o[r * o_sr + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int D>
static int launch_decode(const void* q, const void* k, const void* v,
                         const int* pos, float* part, void* o, int S, int H,
                         int groups, int Smax, int nsplit, long long q_sr,
                         long long k_sslot, long long k_sseq, long long k_sh,
                         long long v_sslot, long long v_sseq, long long v_sh,
                         long long o_sr, float scale, cudaStream_t stream) {
  flash_decode_partial_kernel<T, D>
      <<<dim3(S * H, nsplit), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), pos, part, H, groups, Smax, nsplit, q_sr,
          k_sslot, k_sseq, k_sh, v_sslot, v_sseq, v_sh, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T, D><<<S * H, D, 0, stream>>>(
      part, static_cast<T*>(o), nsplit, o_sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// Instantiated for head dims 64, 128 and 256 (dk == dv) in f32 and for 64
// in bf16; bf16 at 128 and 256, and f32 there at groups over 2, run
// flash_decode_gqa.cu.
// ``part`` is the f32 scratch [S*H, nsplit, D + 2]; the wrapper has checked
// that k and v are 16-byte aligned with strides of whole 16-byte words.
extern "C" int repro_flash_decode(int dtype, const void* q, const void* k,
                                  const void* v, const void* pos, void* part,
                                  void* o, int S, int H, int D, int groups,
                                  int Smax, int nsplit, long long q_sr,
                                  long long k_sslot, long long k_sseq,
                                  long long k_sh, long long v_sslot,
                                  long long v_sseq, long long v_sh,
                                  long long o_sr, float scale, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  if (nsplit <= 0 || nsplit > 65535 ||
      nsplit * kDecodeSplit < Smax || (nsplit - 1) * kDecodeSplit >= Smax)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_DECODE(T, DD)                                                  \
  launch_decode<T, DD>(q, k, v, p, pt, o, S, H, groups, Smax, nsplit, q_sr,  \
                       k_sslot, k_sseq, k_sh, v_sslot, v_sseq, v_sh, o_sr,   \
                       scale, st)
  if (dtype == kFloat32 && D == 64) return REPRO_DECODE(float, 64);
  if (dtype == kFloat32 && D == 128) return REPRO_DECODE(float, 128);
  if (dtype == kFloat32 && D == 256) return REPRO_DECODE(float, 256);
  if (dtype == kBFloat16 && D == 64) return REPRO_DECODE(__nv_bfloat16, 64);
#undef REPRO_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
