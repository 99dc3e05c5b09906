// Flash-attention prefill for Hopper (sm_90a), fp32 route: the port of the
// TPU kernel ``flash_attention`` in src/repro/kernels/flash_attn.py (body
// ``_flash_kernel``).  Head dim 64 runs the persistent kernel described
// below; 128 and 256 a persistent kernel of their own
// (``flash_prefill_f32_tiled_kernel``, further down, on the warp tile of
// flash_f32_tile.cuh).  This file serves float32 only; bfloat16 (the serve
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
#include "flash_f32_tile.cuh"

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

// ---------------------------------------------------------------------------
// Head dims 128 and 256: a persistent, register-tiled kernel.  The kernel
// above keeps a whole 64 x 64 output tile in 128 registers a thread; at
// D = 128 or 256 that tile no longer fits, so these dims take their own
// shape, built on the warp tile of flash_f32_tile.cuh (which says what
// bounds it: 128-bit shared loads against FMAs):
//  * A block is 8 warps, one an SM (``__launch_bounds__(256, 1)``, up to
//    255 registers a thread).  A work item is 8 warps' rows: at D = 128 a
//    warp owns 16 rows, a lane 8 of them x 4 keys of a 64-key tile and x 8
//    output dims; at D = 256 a warp owns 8 rows, a lane 4 x 4 keys and x 16
//    dims.  The shared pipe then needs 0.88 (D = 128) or 1.31 (256) of the
//    FMA pipe's time (flash_f32_tile.cuh counts it; a one-row-group tile
//    at 256, 1.13 on paper, ran slower on an H100).  Each K/V tile in
//    shared memory serves all of the item's rows.
//  * An item packs ``hs`` heads of one kv group (hs = the largest of 8, 4,
//    2, 1 that divides kv_groups) at the same rows / hs query positions:
//    one K/V tile serves hs heads, and the causal diagonal costs a strip of
//    rows / hs positions, not of rows.
//  * Items are numbered heaviest first (the last query tiles of the causal
//    triangle first) and dealt to one persistent block an SM in snake
//    order.  Where there are fewer items than SMs, each item's key tiles
//    are cut into ``nc`` chunks of nearly equal length, one work unit each,
//    so short prompts and few heads still fill the card: a unit leaves its
//    rows' (acc, m, l) in an f32 scratch and a second launch merges each
//    row's chunks in chunk order (no atomics).  (Merging in the item's last
//    unit instead, counted with an integer atomic, was slower on an H100:
//    one block's merge loads wait on L2 one after another.)
//  * K and V have one buffer each, loaded with cp.async so that each lands
//    while the other is in use: V(t) while Q K^T(t) runs, K(t+1) while
//    P V(t) runs (two barriers a tile).  A misaligned view takes 4-byte
//    loads instead.  A warp skips the tiles that lie wholly above its part
//    of the causal diagonal; masks are evaluated only on tiles that cross
//    it or the ragged key end.
// Shared memory: Q rows x (D+4), K 64 x (D+4), V 64 x D, P rows x 80
// floats: 171 KB at D = 128 (128 rows), 214 KB at 256 (64 rows).
// ``flash_attn.wide_prefill_geometry`` computes hs, nc and the grid.
// Measured by tools/flash_vs_parent.py on an NVIDIA H100 80GB HBM3 at
// 700 W: 0.425 ms at granite's causal [48, 1024, 128] (45% of the f32
// operation bound; the earlier 32-row tiled kernel 0.708 ms, fp32 SDPA
// 1.36), 0.510 ms at gemma3's [8, 2048, 256] (50%; 0.805, 1.27).
// ---------------------------------------------------------------------------

constexpr int kXWarps = 8;
constexpr int kXThreads = 32 * kXWarps;
constexpr int kXKeys = 64;  // keys of a K/V tile

template <int D>
struct XGeo {
  // warp tile: 2 row groups of 16 lanes, 8 (D = 128) or 4 (256) rows a
  // lane, 4 keys a lane (64 a warp)
  using Tile = F32Tile<D, 2, D == 128 ? 8 : 4, 4>;
  static constexpr int RW = Tile::ROWS;          // rows of a warp
  static constexpr int ROWS = kXWarps * RW;      // rows of an item
  static_assert(Tile::KEYS == kXKeys, "a warp takes the whole key tile");
};

template <int D>
struct XSmem {
  float q[XGeo<D>::ROWS * (D + 4)];
  float k[kXKeys * (D + 4)];
  float v[kXKeys * D];
  float p[XGeo<D>::ROWS * XGeo<D>::Tile::LDP];
};

// Rows r0..r0+n-1 of a [rows, D] f32 matrix with row stride ``ss`` into
// ``dst`` (row stride ``ld``), by the block's threads; rows at or past
// ``nrows`` are zero.
template <int D, bool kVec>
__device__ __forceinline__ void load_rows_wide(float* dst, int ld,
                                               const float* src, long long ss,
                                               int r0, int n, int nrows) {
  if (kVec) {
    for (int c = threadIdx.x; c < n * (D / 4); c += kXThreads) {
      const int r = c / (D / 4);
      const int col = (c % (D / 4)) * 4;
      const bool ok = r0 + r < nrows;
      cp_async16(dst + r * ld + col,
                 ok ? src + (long long)(r0 + r) * ss + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += kXThreads) {
      const int r = e / D;
      const int col = e % D;
      dst[r * ld + col] =
          r0 + r < nrows ? src[(long long)(r0 + r) * ss + col] : 0.f;
    }
  }
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kXThreads, 1)
flash_prefill_f32_tiled_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, float* __restrict__ part,
                               int BH, int Sq, int Sk, int groups, int causal,
                               int hs, int nc, long long q_sbh, long long q_ss,
                               long long k_sbh, long long k_ss,
                               long long v_sbh, long long v_ss,
                               long long o_sbh, long long o_ss,
                               float scale_log2) {
  using X = XGeo<D>;
  using Tile = typename X::Tile;
  constexpr int LDQ = Tile::LDQ;
  constexpr int RW = X::RW;
  constexpr int RG = Tile::NRG;
  constexpr int R = Tile::NR;  // rows of a lane
  extern __shared__ float4 smem_raw[];
  XSmem<D>& sm = *reinterpret_cast<XSmem<D>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane / Tile::TC;
  const int tc = lane % Tile::TC;
  const int qt_rows = X::ROWS / hs;  // query positions of an item
  const int n_qt = (Sq + qt_rows - 1) / qt_rows;
  const int nhg = groups / hs;
  const int per_qt = (BH / groups) * nhg;  // items of one query tile
  const long long n_units = (long long)per_qt * n_qt * nc;
  const int G = gridDim.x;
  const int b = blockIdx.x;

  for (int r = 0;; ++r) {
    const long long u = (long long)r * G + ((r & 1) ? G - 1 - b : b);
    if (u >= n_units) break;
    const int item = static_cast<int>(u / nc);
    const int c = static_cast<int>(u - (long long)item * nc);
    const int tq = item / per_qt;
    const int rem = item - tq * per_qt;
    const int kvh = rem / nhg;
    const int h0 = kvh * groups + (rem - kvh * nhg) * hs;  // first head
    const int q0 = (causal ? n_qt - 1 - tq : tq) * qt_rows;
    const int k_end = causal ? min(Sk, min(q0 + qt_rows, Sq)) : Sk;
    const int nt = (k_end + kXKeys - 1) / kXKeys;
    const int ta = static_cast<int>((long long)c * nt / nc);
    const int tb = static_cast<int>((long long)(c + 1) * nt / nc);
    // this warp's head and positions p0 + rg + RG i
    const int wh = h0 + RW * warp / qt_rows;
    const int p0 = q0 + RW * warp % qt_rows;
    int lim[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      lim[i] = causal ? min(Sk, p0 + rg + RG * i + 1) : Sk;
    const int wlo = causal ? min(Sk, p0 + 1) : Sk;   // the warp's least limit
    const int whi = causal ? min(Sk, p0 + RW) : Sk;  // and its greatest
    const float* kp = k + kvh * k_sbh;
    const float* vp = v + kvh * v_sbh;
    float* ps = sm.p + RW * warp * Tile::LDP;

    cp_async_wait<0>();
    __syncthreads();  // the previous unit is done with Q, K, V and P
    // Q: row r is head h0 + r / qt_rows at position q0 + r % qt_rows
    for (int e = tid; e < X::ROWS * (D / 4); e += kXThreads) {
      const int rr = e / (D / 4);
      const int col = (e % (D / 4)) * 4;
      const int pos = q0 + rr % qt_rows;
      const bool ok = pos < Sq;
      const float* src =
          q + (h0 + rr / qt_rows) * q_sbh + (long long)pos * q_ss + col;
      float* dst = sm.q + rr * LDQ + col;
      if (kVec) {
        cp_async16(dst, ok ? src : q, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j] = ok ? src[j] : 0.f;
      }
    }
    if (ta < tb)
      load_rows_wide<D, kVec>(sm.k, LDQ, kp, k_ss, ta * kXKeys, kXKeys, Sk);
    cp_async_commit();

    Tile tile;
    tile.init();
    for (int t = ta; t < tb; ++t) {
      const int k0 = t * kXKeys;
      const bool active = k0 < whi;  // else the tile lies above the warp
      cp_async_wait<0>();
      __syncthreads();  // K(t) landed; every warp is done with V(t-1)
      load_rows_wide<D, kVec>(sm.v, D, vp, v_ss, k0, kXKeys, Sk);
      cp_async_commit();
      if (active)
        tile.scores(sm.q + RW * warp * LDQ, sm.k, ps, k0, lim,
                    k0 + kXKeys > wlo, scale_log2, rg, tc);
      cp_async_wait<0>();
      __syncthreads();  // V(t) landed; every warp is done with K(t)
      if (t + 1 < tb) {
        load_rows_wide<D, kVec>(sm.k, LDQ, kp, k_ss, k0 + kXKeys, kXKeys,
                                Sk);
        cp_async_commit();
      }
      if (active) tile.accumulate(sm.v, ps, rg, tc);
    }

    tile.row_sums();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int pos = p0 + rg + RG * i;
      if (pos >= Sq) continue;
      if (nc == 1) {
        const float lc = fmaxf(tile.l[i], 1e-30f);
        float* op = o + wh * o_sbh + (long long)pos * o_ss + 4 * tc;
#pragma unroll
        for (int e = 0; e < Tile::E; ++e) {
          const float4 r4 = make_float4(
              tile.acc[i][e][0] / lc, tile.acc[i][e][1] / lc,
              tile.acc[i][e][2] / lc, tile.acc[i][e][3] / lc);
          float* oe = op + 4 * Tile::TC * e;
          if (kVec) {
            *reinterpret_cast<float4*>(oe) = r4;
          } else {
            oe[0] = r4.x;
            oe[1] = r4.y;
            oe[2] = r4.z;
            oe[3] = r4.w;
          }
        }
      } else {  // this chunk's (acc, m, l) of the row
        float* pr = part + (((long long)wh * Sq + pos) * nc + c) * (D + 4);
        if (tc == 0) {
          pr[D] = tile.m[i];
          pr[D + 1] = tile.l[i];
        }
#pragma unroll
        for (int e = 0; e < Tile::E; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pr[4 * Tile::TC * e + 4 * tc + j] = tile.acc[i][e][j];
      }
    }
  }
  cp_async_wait<0>();
}

// The chunks' merge: out = sum_c acc_c 2^(m_c - m) / max(sum_c l_c 2^(m_c -
// m), 1e-30) over c in order, m = max_c m_c.  A chunk's record of a row is
// (acc[D], m, l, 2 floats of padding), so a thread takes 4 dims of a row
// with 16-byte loads; 256 threads take 1024 / D rows.
constexpr int kCombineThreads = 256;

template <int D, bool kVec>
__global__ void __launch_bounds__(kCombineThreads)
flash_prefill_f32_combine_kernel(const float* __restrict__ part,
                                 float* __restrict__ o, long long rows,
                                 int Sq, int nc, long long o_sbh,
                                 long long o_ss) {
  constexpr int TPR = D / 4;  // threads a row
  const long long r = (long long)blockIdx.x * (kCombineThreads / TPR) +
                      threadIdx.x / TPR;  // head * Sq + position
  if (r >= rows) return;
  const int d = 4 * (threadIdx.x % TPR);
  const float* pr = part + r * nc * (D + 4);
  float m = kNegInf;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, pr[c * (D + 4) + D]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const float* pc = pr + c * (D + 4);
    const float w = exp2f(pc[D] - m);
    const float4 x = *reinterpret_cast<const float4*>(pc + d);
    l += pc[D + 1] * w;
    a.x += x.x * w;
    a.y += x.y * w;
    a.z += x.z * w;
    a.w += x.w * w;
  }
  const float lc = fmaxf(l, 1e-30f);
  const long long bh = r / Sq;
  float* op = o + bh * o_sbh + (r - bh * Sq) * o_ss + d;
  if (kVec) {
    *reinterpret_cast<float4*>(op) =
        make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc);
  } else {
    op[0] = a.x / lc;
    op[1] = a.y / lc;
    op[2] = a.z / lc;
    op[3] = a.w / lc;
  }
}

template <int D, bool kVec>
int launch_tiled(const float* q, const float* k, const float* v, float* o,
                 float* part, int BH, int Sq, int Sk, int groups, int causal,
                 int hs, int nc, int grid, long long q_sbh, long long q_ss,
                 long long k_sbh, long long k_ss, long long v_sbh,
                 long long v_ss, long long o_sbh, long long o_ss, float scale,
                 cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_prefill_f32_tiled_kernel<D, kVec>>(
      static_cast<int>(sizeof(XSmem<D>)));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_f32_tiled_kernel<D, kVec>
      <<<grid, kXThreads, sizeof(XSmem<D>), stream>>>(
          q, k, v, o, part, BH, Sq, Sk, groups, causal, hs, nc, q_sbh, q_ss,
          k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss, scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nc == 1) return static_cast<int>(e);
  const long long rows = (long long)BH * Sq;
  const long long per = kCombineThreads / (D / 4);
  flash_prefill_f32_combine_kernel<D, kVec>
      <<<static_cast<unsigned>((rows + per - 1) / per), kCombineThreads, 0,
         stream>>>(part, o, rows, Sq, nc, o_sbh, o_ss);
  return static_cast<int>(cudaGetLastError());
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

// float32, head dim 64: the persistent kernel above.
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

// float32, head dims 128 and 256: the tiled persistent kernel.  ``hs``
// (heads an item), ``nc`` (chunks an item) and ``grid`` come from
// ``flash_attn.wide_prefill_geometry``; ``part`` is the f32 scratch
// [BH * Sq, nc, D + 4] when nc > 1 (unused otherwise).
extern "C" int repro_flash_prefill_wide(const void* q, const void* k,
                                        const void* v, void* o, void* part,
                                        int BH, int Sq, int Sk, int D,
                                        int groups, int causal, int hs,
                                        int nc, int grid, long long q_sbh,
                                        long long q_ss, long long k_sbh,
                                        long long k_ss, long long v_sbh,
                                        long long v_ss, long long o_sbh,
                                        long long o_ss, float scale,
                                        void* stream) {
  using namespace repro;
  if ((D != 128 && D != 256) || BH <= 0 || Sq <= 0 || Sk < 0 ||
      groups <= 0 || BH % groups != 0 || hs <= 0 || hs > 8 ||
      (hs & (hs - 1)) != 0 || groups % hs != 0 || nc <= 0 || grid <= 0 ||
      (nc > 1 && part == nullptr) || (long long)BH * Sq > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  float* fp = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(q, q_sbh, q_ss) && aligned16(k, k_sbh, k_ss) &&
                   aligned16(v, v_sbh, v_ss) && aligned16(o, o_sbh, o_ss);
#define REPRO_TILED(DD, V)                                                   \
  launch_tiled<DD, V>(fq, fk, fv, fo, fp, BH, Sq, Sk, groups, causal, hs,    \
                      nc, grid, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss,       \
                      o_sbh, o_ss, scale, st)
  if (D == 128) return vec ? REPRO_TILED(128, true) : REPRO_TILED(128, false);
  return vec ? REPRO_TILED(256, true) : REPRO_TILED(256, false);
#undef REPRO_TILED
}
