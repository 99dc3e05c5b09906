// Flash-attention prefill for Hopper (sm_90a), fp32 route: the port of the
// TPU kernel ``flash_attention`` in src/repro/kernels/flash_attn.py (body
// ``_flash_kernel``).  This file serves float32 only; bfloat16 (the serve
// path) runs on the tensor cores in flash_prefill_sm90.cu.  fp32 runs on the
// CUDA cores in IEEE f32 FMAs: tensor cores would mean TF32 (10-bit
// mantissas), which the fp32 check (atol = rtol = 2e-5 against the plain
// version) rightly refuses.
//
// Computes, for every (batch*head) row block, causal or full online-softmax
// attention: scores in f32 scaled by dk^-0.5, masked entries at -1e30, a
// running (m, l, acc) in f32, l clamped at 1e-30, output in f32.  Causal
// means key kr <= query row.  GQA: query head ``bh`` reads kv head
// ``bh / groups`` in place (never a repeated copy).  Any Sq/Sk; q, k, v, o
// are read and written through their (batch*head, row) strides.
//
// Bound.  ~4*BH*D*L^2/2 FLOPs (causal) against 4*BH*L*D*4 bytes: at
// [32, 512, 64] 1.08 GFLOP, 0.0161 ms at 67 TFLOP/s (f32 outside the tensor
// cores), far above the 0.0050 ms byte bound.  So the design is about
// keeping the FMA pipes fed, on every SM until the end.
//
// Design: a register-tiled SIMT flash kernel in persistent blocks.
//  * A work item is a 64-row query tile of one head.  Items are numbered
//    heaviest first (the last tiles of the causal triangle first) and dealt
//    to one block per SM in snake order, so every block's items add up to
//    about the same number of key tiles.  With one kernel block per query
//    tile instead, the hardware placed two of the heaviest tiles on one SM
//    and the causal [32, 512, 64] case took as long as the full one.
//  * A block is two warpgroups of 8 warps.  Each item's key tiles are split
//    between them (the first half to warpgroup 0, the rest to warpgroup 1);
//    at the item's end warpgroup 1 leaves its (m, l, acc) in shared memory
//    and warpgroup 0 merges the two and writes the rows.
//  * Lane (rg = lane / 16, tc = lane % 16) of warp w owns query rows
//    8w + rg + 2i (i < 4), the scores of keys tc + 16j (j < 4) and the
//    output dims 4tc..4tc+3: a 4 x 4 score tile and a 4 x 4 output tile in
//    registers (128 registers, the most 512 threads an SM allow).
//  * Q, K and V stay row-major in shared memory, as ``cp.async`` copies
//    them (16 bytes a copy); the dot products are vectorised along the head
//    dim instead of transposing: each 128-bit load of Q[row][d..d+3] or
//    K[key][d..d+3] feeds 16 FMAs.  Q and K rows are padded to 68 floats
//    and P rows to 80, so no shared load or store has a bank conflict
//    beyond its unique bytes.
//  * Each warpgroup double-buffers its K and V tiles (tile t+1's copies
//    are issued before tile t's math; a named barrier per warpgroup a
//    tile), and during an item's last tile it fetches the next item's first
//    K/V tile and its half of the next Q tile (Q is double-buffered).
//  * The row max is reduced over the 16 lanes of a row with shuffles; the
//    row sum stays a per-lane partial until the end (its rescale factor is
//    the same on all 16 lanes).  P goes through shared memory for the PV
//    product; a warp reads only its own rows of P, so a ``__syncwarp``
//    suffices.
//  * Scores are taken in the log2 domain (q.k times dk^-0.5 * log2(e), then
//    exp2f), which moves each p by a few f32 ulps at most.
//  * Causal tiles above the diagonal are never visited; the masks are
//    evaluated only on tiles that cross the diagonal or the ragged key end.
// Tensors whose base or strides are not 16-byte multiples (a misaligned
// view) take the same kernel with plain 4-byte loads instead of cp.async.
// Measured by chip_smoke.py phase 3b on an NVIDIA H100 80GB HBM3 at
// 700.00 W: 0.0463 ms at [32, 512, 64] causal (the earlier one-thread-a-row
// kernel: 0.26 ms; fp32 SDPA 0.074-0.076 ms).
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kD = 64;         // head dim (dk == dv)
constexpr int kBQ = 64;        // query rows of a work item
constexpr int kBK = 64;        // keys of a K/V tile
constexpr int kWarps = 8;      // warps of a warpgroup
constexpr int kWG = 2;         // warpgroups of a block
constexpr int kWGThreads = 32 * kWarps;
constexpr int kThreads = kWG * kWGThreads;
constexpr int kTC = 16;        // lanes that share a query row
constexpr int kRG = 32 / kTC;  // row groups of a warp
constexpr int kRW = kBQ / kWarps;  // rows a warp owns
constexpr int kR = kRW / kRG;  // rows a lane owns
constexpr int kK = kBK / kTC;  // keys a lane owns in a tile
constexpr int kLdQK = kD + 4;  // padded row of the Q and K tiles (floats)
constexpr int kLdV = kD;
constexpr int kLdP = kBK + kTC;
constexpr float kLog2e = 1.4426950408889634f;

struct WGSmem {
  float k[2][kBK * kLdQK];
  float v[2][kBK * kLdV];
  float p[kBQ * kLdP];  // P; at an item's end, warpgroup 0's holds the
                        // partial result of warpgroup 1
};

struct Smem {
  float q[2][kBQ * kLdQK];  // this item's Q tile and the next one's
  WGSmem wg[kWG];
};

// Rows r0..r0+n-1 of a [rows, 64] f32 matrix with row stride ``ss`` into
// ``dst`` (row stride ``ld``), copied by ``nt`` threads (this one is
// ``tid``); rows at or past ``nrows`` are zero.
template <bool kVec>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long ss,
                                          int r0, int n, int nrows, int tid,
                                          int nt) {
  if (kVec) {
    for (int c = tid; c < n * (kD / 4); c += nt) {
      const int r = c >> 4;
      const int col = (c & 15) * 4;
      const bool ok = r0 + r < nrows;
      cp_async16(dst + r * ld + col,
                 ok ? src + (long long)(r0 + r) * ss + col : src, ok);
    }
  } else {
    for (int e = tid; e < n * kD; e += nt) {
      const int r = e >> 6;
      const int col = e & 63;
      dst[r * ld + col] =
          r0 + r < nrows ? src[(long long)(r0 + r) * ss + col] : 0.f;
    }
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < kTC; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kTC; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" :: "r"(wg + 1), "r"(kWGThreads)
               : "memory");
}

// A work item: the query tile ``q0`` of head ``bh``, and the key tiles
// [ta, tb) that one warpgroup takes of it (warpgroup 0 the first half,
// warpgroup 1 the rest).  Items are numbered heaviest first (the last
// query tiles of the causal triangle first) and dealt to the blocks in
// snake order: round r gives item r*G + b to block b (r even) or to block
// G-1-b (r odd), so each block's items sum to about the same work.
struct Item {
  bool ok;
  int bh, q0, ta, tb;
};

__device__ __forceinline__ Item get_item(int r, int wg, int BH, int Sq,
                                         int Sk, int causal) {
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int kidx = r * G + ((r & 1) ? G - 1 - b : b);
  Item it;
  it.ok = kidx < BH * n_qt;
  it.bh = kidx % BH;
  const int qt = causal ? n_qt - 1 - kidx / BH : kidx / BH;
  it.q0 = qt * kBQ;
  const int k_end = causal ? min(Sk, min(it.q0 + kBQ, Sq)) : Sk;
  const int nt = (k_end + kBK - 1) / kBK;
  const int half = (nt + 1) / 2;
  it.ta = wg == 0 ? 0 : half;
  it.tb = wg == 0 ? half : nt;
  return it;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int BH, int Sq, int Sk, int groups, int causal,
                         long long q_sbh, long long q_ss, long long k_sbh,
                         long long k_ss, long long v_sbh, long long v_ss,
                         long long o_sbh, long long o_ss, float scale_log2) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int wt = tid % kWGThreads;  // thread within the warpgroup
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int rg = lane / kTC;
  const int tc = lane % kTC;
  WGSmem& ws = sm.wg[wg];
  int rows[kR];  // this lane's rows of the query tile
#pragma unroll
  for (int i = 0; i < kR; ++i) rows[i] = warp * kRW + rg + kRG * i;

  // this warpgroup's share of an item's first loads: Q rows
  // [32 wg, 32 wg + 32) and its first K/V tile
  auto prefetch = [&](const Item& it, float* qdst, int buf) {
    load_rows<kVec>(qdst + 32 * wg * kLdQK, kLdQK, q + it.bh * q_sbh, q_ss,
                    it.q0 + 32 * wg, 32, Sq, wt, kWGThreads);
    if (it.ta < it.tb) {
      const int kvh = it.bh / groups;
      load_rows<kVec>(ws.k[buf], kLdQK, k + kvh * k_sbh, k_ss,
                      it.ta * kBK, kBK, Sk, wt, kWGThreads);
      load_rows<kVec>(ws.v[buf], kLdV, v + kvh * v_sbh, v_ss,
                      it.ta * kBK, kBK, Sk, wt, kWGThreads);
    }
  };

  Item cur = get_item(0, wg, BH, Sq, Sk, causal);
  int qb = 0;  // Q buffer of the current item
  int kb = 0;  // K/V buffer that holds this warpgroup's first tile of it
  if (cur.ok) prefetch(cur, sm.q[0], 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int r = 0; cur.ok; ++r) {
    const Item nxt = get_item(r + 1, wg, BH, Sq, Sk, causal);
    const int bh = cur.bh, q0 = cur.q0, ta = cur.ta, tb = cur.tb;
    const float* qs = sm.q[qb];
    const int kvh = bh / groups;
    const float* kp = k + kvh * k_sbh;
    const float* vp = v + kvh * v_sbh;

    float acc[kR][4];
    float m[kR], l[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    int nkb = kb;  // where the next item's first tile goes
    if (ta == tb && nxt.ok) {  // no tile of this item: fetch at once
      prefetch(nxt, sm.q[qb ^ 1], nkb);
      cp_async_commit();
    }

    for (int t = ta; t < tb; ++t) {
      const int buf = kb ^ ((t - ta) & 1);
      if (t > ta) {
        cp_async_wait<0>();
        wg_sync(wg);  // tile t landed; tile t-1's buffers are free
      }
      if (t + 1 < tb) {
        load_rows<kVec>(ws.k[buf ^ 1], kLdQK, kp, k_ss, (t + 1) * kBK, kBK,
                        Sk, wt, kWGThreads);
        load_rows<kVec>(ws.v[buf ^ 1], kLdV, vp, v_ss, (t + 1) * kBK, kBK,
                        Sk, wt, kWGThreads);
      } else if (nxt.ok) {
        // the last tile: the next item's loads overlap its math
        nkb = buf ^ 1;
        prefetch(nxt, sm.q[qb ^ 1], nkb);
      }
      cp_async_commit();
      const float* ks = ws.k[buf];
      const float* vs = ws.v[buf];
      const int k0 = t * kBK;

      // S = Q K^T for this lane's kR rows x kK keys
      float s[kR][kK];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kK; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        float4 qv[kR], kv[kK];
#pragma unroll
        for (int i = 0; i < kR; ++i) qv[i] = ld4(qs + rows[i] * kLdQK + d);
#pragma unroll
        for (int j = 0; j < kK; ++j)
          kv[j] = ld4(ks + (tc + kTC * j) * kLdQK + d);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }

      // online softmax; masks only on tiles that cross the diagonal or Sk
      const bool masked = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int row = q0 + rows[i];
        float mt = kNegInf;
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          float x = s[i][j] * scale_log2;
          if (masked) {
            const int kr = k0 + tc + kTC * j;
            if (kr >= Sk || (causal && kr > row)) x = kNegInf;
          }
          s[i][j] = x;
          mt = fmaxf(mt, x);
        }
        const float m_new = fmaxf(m[i], row_max(mt));
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          float p = exp2f(s[i][j] - m_new);
          if (masked) {
            const int kr = k0 + tc + kTC * j;
            if (kr >= Sk || (causal && kr > row)) p = 0.f;
          }
          psum += p;
          ws.p[rows[i] * kLdP + tc + kTC * j] = p;
        }
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      }
      __syncwarp();  // this warp's rows of P are written

      // acc += P V for this lane's kR rows x 4 dims
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 pv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) pv[i] = ld4(ws.p + rows[i] * kLdP + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 vv = ld4(vs + (kk + c) * kLdV + 4 * tc);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const float pc = comp(pv[i], c);
            acc[i][0] = fmaf(pc, vv.x, acc[i][0]);
            acc[i][1] = fmaf(pc, vv.y, acc[i][1]);
            acc[i][2] = fmaf(pc, vv.z, acc[i][2]);
            acc[i][3] = fmaf(pc, vv.w, acc[i][3]);
          }
        }
      }
      __syncwarp();  // P is read before the next tile overwrites it
    }

    // merge: once both warpgroups are done (and the next item's loads have
    // landed), warpgroup 1 leaves its (m, l, acc) in warpgroup 0's P
    // buffer; warpgroup 0 combines the two and writes the rows, while
    // warpgroup 1 goes on to the next item.  A warp's rows of the partial
    // result overlap another warp's rows of P, so warpgroup 0 meets at a
    // barrier after its reads, before any warp stores the next item's P.
    float* part = sm.wg[0].p;  // [row][m, l, acc[64]]
    constexpr int kLdPart = kD + 2;
#pragma unroll
    for (int i = 0; i < kR; ++i) l[i] = row_sum(l[i]);
    cp_async_wait<0>();
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float* pr = part + rows[i] * kLdPart;
        if (tc == 0) {
          pr[0] = m[i];
          pr[1] = l[i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) pr[2 + 4 * tc + j] = acc[i][j];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int row = q0 + rows[i];
        const float* pr = part + rows[i] * kLdPart;
        const float m1 = pr[0];
        const float mm = fmaxf(m[i], m1);
        const float a0 = exp2f(m[i] - mm);
        const float a1 = exp2f(m1 - mm);
        const float lc = fmaxf(l[i] * a0 + pr[1] * a1, 1e-30f);
        float r4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r4[j] = (acc[i][j] * a0 + pr[2 + 4 * tc + j] * a1) / lc;
        if (row < Sq) {
          float* op = o + bh * o_sbh + (long long)row * o_ss + 4 * tc;
          if (kVec) {
            *reinterpret_cast<float4*>(op) =
                make_float4(r4[0], r4[1], r4[2], r4[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) op[j] = r4[j];
          }
        }
      }
      wg_sync(0);  // every warp has read ``part``
    }
    cur = nxt;
    qb ^= 1;
    kb = nkb;
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p, long long s0, long long s1) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0;
}

template <bool kVec>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int Sq, int Sk, int groups, int causal, long long q_sbh,
           long long q_ss, long long k_sbh, long long k_ss, long long v_sbh,
           long long v_ss, long long o_sbh, long long o_ss, float scale,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<flash_prefill_f32_kernel<kVec>>(
      static_cast<int>(sizeof(Smem)));
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM; each walks its share of the items
  const long long items = (long long)BH * ((Sq + kBQ - 1) / kBQ);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_prefill_f32_kernel<kVec><<<grid, kThreads, sizeof(Smem), stream>>>(
      q, k, v, o, BH, Sq, Sk, groups, causal, q_sbh, q_ss, k_sbh, k_ss,
      v_sbh, v_ss, o_sbh, o_ss, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
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
  if (dtype != kFloat32 || D != kD || BH <= 0 || Sq <= 0 || Sk < 0 ||
      groups <= 0 || BH % groups != 0 ||
      (long long)BH * ((Sq + kBQ - 1) / kBQ) > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(q, q_sbh, q_ss) && aligned16(k, k_sbh, k_ss) &&
                   aligned16(v, v_sbh, v_ss) && aligned16(o, o_sbh, o_ss);
  return vec ? launch<true>(fq, fk, fv, fo, BH, Sq, Sk, groups, causal,
                            q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, o_sbh,
                            o_ss, scale, st)
             : launch<false>(fq, fk, fv, fo, BH, Sq, Sk, groups, causal,
                             q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, o_sbh,
                             o_ss, scale, st);
}
