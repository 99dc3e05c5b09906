// Grouped-head flash-decode step for Hopper (sm_90a), head dims 128 and
// 256: the port of ``flash_decode_step`` in src/repro/kernels/flash_attn.py
// (a ``lax.scan`` over 128-wide KV blocks, once per layer per generated
// token on the serve path) for the grouped heads of granite, mixtral, qwen,
// internvl2 (128) and gemma3's global layers (256): bf16 at any group, and
// fp32 where the group has more than two query rows (``gqa_f32``, below).
// Head dim 64, and fp32 at groups of 1-2, stay on flash_decode.cu.
//
// What it computes is flash_decode.cu's: the G = H / kv query rows of each
// (slot, kv head) attend to that slot's cached keys [0, pos[slot]], f32
// online softmax, scores scaled by D^-0.5, l clamped at 1e-30, out in the
// input type;
// the cache is read in its stored layout [S, max_seq, kv, D] by strides and
// ``pos`` is an int32 device vector (the host never reads it).
//
// Design: split-KV, two launches, each K/V row read once per group.
//   Pass 1, grid (head tiles, NSPLIT, S * kv): a block owns one (slot, kv
// head, split) and computes the group's query rows (all of them, but at
// G > 48, or G > 32 at D = 256) against the split's keys.  Its threads
// stage the split's K and V rows in shared memory through a cp.async ring
// (TK keys a stage; rows past the split or past pos land as zeros and are
// masked), 16-byte chunks XOR-swizzled by row so that ldmatrix and the
// lanes' 16-byte reads are free of bank conflicts.  The warps of a row
// take the tile's keys in quarters and keep their own (m, l, acc); the
// block merges them in warp order through shared memory and writes the
// split's partial (m, l, acc[D]) per query row to an f32 scratch
// [S*H, NSPLIT, D + 2].  A split that starts past
// pos writes the neutral partial (-1e30, 0, 0) and loads nothing.
//   Pass 2, one block of D threads per query row, combines the splits in
// order 0..NSPLIT-1 (no float atomics), as flash_decode.cu does.
//   The geometry (TK, STAGES, the split width, NSPLIT, the head tiles)
// comes from max_seq, kv, G and D alone, never from S or pos
// (``flash_attn.decode_geometry``), so a slot decodes bitwise alike in any
// batch, and a CUDA graph replays the same launches.
//
// Two bf16 routes, by G:
//   G > 2, "gqa_mma": the group's rows share every key, so the scores are a
// [G, D] x [D, keys] product.  The rows go in m16 tiles (G = 48 fills
// three, mixtral's 6 and qwen's 8 pad one), four warps a tile and up to
// three tiles a block at D = 128 (two at 256, for registers), so granite's
// 48 rows read each K/V stage once.  Each warp runs mma.sync m16n8k16 (bf16
// in, f32 accumulate; bf16 products are exact in f32): S = Q K^T with Q and
// K fragments from ldmatrix, scaled in f32; then O += P V with P split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi) (two products, as K5 does: a
// single bf16 P misses the one-ulp check) and V fragments from
// ldmatrix.trans.  TK = 64 keys a stage, 16 per warp: one k16 step of PV.
//   G <= 2, "gqa_simt" (gemma3's G = 2): a padded m16 tile would be 7/8
// padding.  At 1-2 FMAs per cached byte the CUDA cores keep up with HBM, so
// the scores and P V run in f32 SIMT straight from the shared tile: D/8
// lanes cover a key row with one 16-byte read each, a score ends in a
// butterfly over those lanes.  TK = 32 keys a stage.
//
// Bound.  Decode attention reads each valid cache row once: per tick
// sum_slots (pos + 1) * kv * D * 2 (K and V) * 2 bytes against 2 G FLOPs a
// byte, so the card's memory rate (3.35 TB/s) bounds it; granite's tick at
// max_seq 1024 is ~2.5 MB (0.74 us), so there the launches, the split's
// load latency and filling 132 SMs from 8 (slot, kv head) pairs dominate:
// the split width shrinks until each slot has ~64 blocks.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "flash_f32_tile.cuh"

namespace repro {
namespace {

constexpr int NT = 128;  // 4 warps
constexpr int NW = NT / 32;
constexpr int MROWS = 16;  // query rows of an mma head tile

template <int D, bool MMA>
struct Geo {
  static constexpr int TK = MMA ? 64 : 32;       // keys of a stage
  static constexpr int STAGES = MMA ? 2 : 3;     // ring depth
  static constexpr int CH = D / 8;               // 16-byte chunks of a row
  static constexpr int TILE = TK * D;            // elements of K (or V)
};

// element offset of (row, 16-byte chunk) in a tile of D-element rows: the
// chunk's low 3 bits XOR the row's, so 8 consecutive rows of one chunk hit
// 8 distinct 16-byte bank groups
template <int D>
__device__ __forceinline__ int sw(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// hi = bf16(x), lo = bf16(x - hi), both as bf16x2 pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  memcpy(&hi, &h, sizeof(hi));
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* pos;
  float* part;
  int H, groups, Smax, split, nsplit;
  long long q_sr, k_sslot, k_sseq, k_sh, v_sslot, v_sseq, v_sh;
  float scale;
};

// The block's coordinates and its keys [c0, kend).
struct Block {
  int slot, kvh, ht, split, c0, kend, rows, row0;
};

template <int ROWS, class A>
__device__ __forceinline__ Block block_of(const A& a) {
  Block b;
  b.ht = blockIdx.x;
  b.split = blockIdx.y;
  b.slot = blockIdx.z / (a.H / a.groups);
  b.kvh = blockIdx.z - b.slot * (a.H / a.groups);
  // keys [0, pos] are valid; a position past the cache attends to all of it
  const int n = min(max(a.pos[b.slot], 0), a.Smax - 1) + 1;
  b.c0 = b.split * a.split;
  b.kend = min(b.c0 + a.split, n);
  b.rows = min(ROWS, a.groups - b.ht * ROWS);  // query rows of this block
  b.row0 = b.slot * a.H + b.kvh * a.groups + b.ht * ROWS;
  return b;
}

template <int D, class A>
__device__ __forceinline__ float* part_row(const A& a, const Block& b,
                                           int r) {
  return a.part +
         (static_cast<long long>(b.row0 + r) * a.nsplit + b.split) * (D + 2);
}

// Stage tile ``j`` of the block's keys (K then V) into ``ks``/``vs``;
// rows past kend land as zeros.  One commit group.
template <int D, bool MMA, int NTH>
__device__ __forceinline__ void load_tile(const Args& a, const Block& b,
                                          int j, __nv_bfloat16* ks,
                                          __nv_bfloat16* vs) {
  using G = Geo<D, MMA>;
  const __nv_bfloat16* kb = a.k + b.slot * a.k_sslot + b.kvh * a.k_sh;
  const __nv_bfloat16* vb = a.v + b.slot * a.v_sslot + b.kvh * a.v_sh;
  const int k0 = b.c0 + j * G::TK;
#pragma unroll 4
  for (int i = threadIdx.x; i < G::TK * G::CH; i += NTH) {
    const int r = i / G::CH;
    const int c = i - r * G::CH;
    const int key = k0 + r;
    const bool ok = key < b.kend;
    const long long kk = ok ? key : 0;  // a valid address when zero-filling
    cp_async16(ks + sw<D>(r, c), kb + kk * a.k_sseq + 8 * c, ok);
    cp_async16(vs + sw<D>(r, c), vb + kk * a.v_sseq + 8 * c, ok);
  }
  cp_async_commit();
}

// Merge the NSUB sub-partials (m, l, acc[ROWS][D]) that the warps left in
// shared memory, in index order, and write the split's partial of each of
// the block's query rows.
template <int D, int ROWS, int NSUB, int NTH>
__device__ __forceinline__ void merge_and_store(const Args& a, const Block& b,
                                                const float (&sm_m)[NSUB][ROWS],
                                                const float (&sm_l)[NSUB][ROWS],
                                                float (&sm_e)[NSUB][ROWS],
                                                const float* pacc) {
  const int t = threadIdx.x;
  if (t < b.rows) {
    float m = sm_m[0][t];
#pragma unroll
    for (int j = 1; j < NSUB; ++j) m = fmaxf(m, sm_m[j][t]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      const float e = expf(sm_m[j][t] - m);
      sm_e[j][t] = e;
      l += sm_l[j][t] * e;
    }
    float* out = part_row<D>(a, b, t);
    out[0] = m;
    out[1] = l;
  }
  __syncthreads();
  for (int i = t; i < b.rows * D; i += NTH) {
    const int r = i / D;
    const int d = i - r * D;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
      acc += pacc[(j * ROWS + r) * D + d] * sm_e[j][r];
    part_row<D>(a, b, r)[2 + d] = acc;
  }
}

template <int D, int NTH, class A>
__device__ __forceinline__ void neutral(const A& a, const Block& b) {
  for (int i = threadIdx.x; i < b.rows * (D + 2); i += NTH) {
    const int r = i / (D + 2);
    const int e = i - r * (D + 2);
    part_row<D>(a, b, r)[e] = e == 0 ? kNegInf : 0.f;
  }
}

// ---------------------------------------------------------------------------
// G > 2: tensor cores, MT head tiles of 16 query rows a block
// ---------------------------------------------------------------------------

// m16 tiles a block holds at most (4 warps each): the group's tiles share
// every K/V stage, up to the registers a thread may keep (the kernel takes
// 132 at D = 128, 234 at D = 256)
template <int D>
constexpr int kMmaTiles = D == 128 ? 3 : 2;

// dynamic shared memory of the SIMT kernel: the ring
template <int D>
constexpr int simt_smem() {
  return Geo<D, false>::STAGES * 2 * Geo<D, false>::TILE * 2;
}

template <int D, int MT>
constexpr int mma_smem() {
  using G = Geo<D, true>;
  constexpr int ring = G::STAGES * 2 * G::TILE * 2;
  constexpr int pacc = NW * MT * MROWS * D * 4;  // the warps' partials
  return MT * MROWS * D * 2 + (ring > pacc ? ring : pacc);
}

template <int D, int MT>
__global__ void __launch_bounds__(NT * MT)
gqa_decode_mma_kernel(const Args a) {
  using G = Geo<D, true>;
  constexpr int NS = D / 8;  // n-tiles of 8 output columns
  constexpr int ROWS = MT * MROWS;
  constexpr int NTH = NT * MT;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + ROWS * D;
  // sub-partial j of row r: the key quarter j of r's m16 tile
  __shared__ float sm_m[NW][ROWS], sm_l[NW][ROWS], sm_e[NW][ROWS];

  const Block b = block_of<ROWS>(a);
  if (b.c0 >= b.kend) {  // no valid key here: the neutral partial
    neutral<D, NTH>(a, b);
    return;
  }
  const int t = threadIdx.x;
  const int warp = (t >> 5) & 3;  // key quarter
  const int mt = t >> 7;          // m16 tile
  const int lane = t & 31;
  const int g = lane >> 2;        // fragment rows g and g + 8
  const int c2 = 2 * (lane & 3);  // fragment columns c2, c2 + 1
  const __nv_bfloat16* qt = qs + mt * MROWS * D;  // this warp's tile of Q

  const int ntiles = (b.kend - b.c0 + G::TK - 1) / G::TK;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < ntiles)
      load_tile<D, true, NTH>(a, b, s, ring + s * 2 * G::TILE,
                         ring + (s * 2 + 1) * G::TILE);
    else
      cp_async_commit();
  }
  // Q [ROWS, D] into shared memory while the first K/V rows are in flight
  // (rows past the group are zeros); any alignment, so element loads
  for (int i = t; i < ROWS * D; i += NTH) {
    const int r = i / D;
    const int d = i - r * D;
    qs[sw<D>(r, d >> 3) + (d & 7)] =
        r < b.rows ? a.q[(b.row0 + r) * a.q_sr + d] : __float2bfloat16(0.f);
  }

  float acc[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // ldmatrix lane addresses: matrix lane >> 3, its row lane & 7
  const int lm = lane >> 3;
  const int lr = lane & 7;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // tile j landed for every thread; stage j-1 is free
    if (j + G::STAGES - 1 < ntiles) {
      const int s = (j + G::STAGES - 1) % G::STAGES;
      load_tile<D, true, NTH>(a, b, j + G::STAGES - 1,
                              ring + s * 2 * G::TILE,
                         ring + (s * 2 + 1) * G::TILE);
    } else {
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (j % G::STAGES) * 2 * G::TILE;
    const __nv_bfloat16* vs = ks + G::TILE;
    const int kr = 16 * warp;  // this warp's 16 keys of the tile

    // S[16 x 16] = Q K^T: A = Q (rows lr + 8 (lm & 1), chunk 2kk + lm/2),
    // B = K rows kr + 8 (lm >> 1) + lr, chunk 2kk + (lm & 1)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, qt + sw<D>(lr + 8 * (lm & 1), 2 * kk + (lm >> 1)));
      ldsm_x4(kb, ks + sw<D>(kr + 8 * (lm >> 1) + lr, 2 * kk + (lm & 1)));
      mma16816(s[0], qa, kb[0], kb[1]);
      mma16816(s[1], qa, kb[2], kb[3]);
    }

    // online softmax on the fragment: s[n][c] is row g + 8 (c >> 1), key
    // kr + 8n + c2 + (c & 1)
    const int kbase = b.c0 + j * G::TK + kr;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = kbase + 8 * n + c2 + (c & 1) < b.kend;
        s[n][c] = ok ? s[n][c] * a.scale : kNegInf;
        mt[c >> 1] = fmaxf(mt[c >> 1], s[n][c]);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = kbase + 8 * n + c2 + (c & 1) < b.kend;
        const float p = ok ? expf(s[n][c] - m[c >> 1]) : 0.f;
        s[n][c] = p;
        ps[c >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = l[h] * alpha[h] + ps[h];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];

    // O += P_hi V + P_lo V: the S fragment is the A fragment of P [16 x 16
    // keys]; V through ldmatrix.trans (rows kr + 8 (lm & 1) + lr, chunk
    // 2dd + (lm >> 1)) gives the B fragments of output n-tiles 2dd, 2dd+1
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + sw<D>(kr + 8 * (lm & 1) + lr, 2 * dd + (lm >> 1)));
      mma16816(acc[2 * dd], ph, vb[0], vb[1]);
      mma16816(acc[2 * dd], pl, vb[0], vb[1]);
      mma16816(acc[2 * dd + 1], ph, vb[2], vb[3]);
      mma16816(acc[2 * dd + 1], pl, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there

  float* pacc = reinterpret_cast<float*>(ring);  // [NW][ROWS][D]
  const int row = mt * MROWS + g;
  if ((lane & 3) == 0) {
    sm_m[warp][row] = m[0];
    sm_m[warp][row + 8] = m[1];
    sm_l[warp][row] = l[0];
    sm_l[warp][row + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      pacc[(warp * ROWS + row + 8 * (c >> 1)) * D + 8 * n + c2 + (c & 1)] =
          acc[n][c];
  __syncthreads();
  merge_and_store<D, ROWS, NW, NTH>(a, b, sm_m, sm_l, sm_e, pacc);
}

// ---------------------------------------------------------------------------
// G <= 2: f32 SIMT from the shared tile, the whole group a block
// ---------------------------------------------------------------------------

template <int D, int GR>
__global__ void __launch_bounds__(NT)
gqa_decode_simt_kernel(const Args a) {
  using Ge = Geo<D, false>;
  constexpr int LANES = D / 8;      // lanes that cover a key row
  constexpr int GPW = 32 / LANES;   // keys of a warp at once
  constexpr int KPW = Ge::TK / NW;  // keys of a warp per tile: 8
  constexpr int STEPS = KPW / GPW;
  constexpr int NSUB = NW * GPW;    // lane groups, each with (m, l, acc)
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float sm_m[NSUB][GR], sm_l[NSUB][GR], sm_e[NSUB][GR];

  const Block b = block_of<GR>(a);
  if (b.c0 >= b.kend) {
    neutral<D, NT>(a, b);
    return;
  }
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane / LANES;
  const int sub = lane % LANES;  // owns elements [8 sub, 8 sub + 8)

  const int ntiles = (b.kend - b.c0 + Ge::TK - 1) / Ge::TK;
#pragma unroll
  for (int s = 0; s < Ge::STAGES - 1; ++s) {
    if (s < ntiles)
      load_tile<D, false, NT>(a, b, s, ring + s * 2 * Ge::TILE,
                          ring + (s * 2 + 1) * Ge::TILE);
    else
      cp_async_commit();
  }
  float qv[GR][8];
#pragma unroll
  for (int h = 0; h < GR; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qv[h][e] = to_f32(a.q[(b.row0 + h) * a.q_sr + 8 * sub + e]) * a.scale;

  float m[GR], l[GR], acc[GR][8];
#pragma unroll
  for (int h = 0; h < GR; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
  }
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<Ge::STAGES - 2>();
    __syncthreads();
    if (j + Ge::STAGES - 1 < ntiles) {
      const int s = (j + Ge::STAGES - 1) % Ge::STAGES;
      load_tile<D, false, NT>(a, b, j + Ge::STAGES - 1, ring + s * 2 * Ge::TILE,
                          ring + (s * 2 + 1) * Ge::TILE);
    } else {
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (j % Ge::STAGES) * 2 * Ge::TILE;
    const __nv_bfloat16* vs = ks + Ge::TILE;
    const int kbase = b.c0 + j * Ge::TK;

    // key of step i: row KPW warp + GPW i + grp of the tile
    float sc[STEPS][GR];
    float mt[GR];
#pragma unroll
    for (int h = 0; h < GR; ++h) mt[h] = kNegInf;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int r = KPW * warp + GPW * i + grp;
      const uint4 w = *reinterpret_cast<const uint4*>(ks + sw<D>(r, sub));
      const __nv_bfloat162* hw = reinterpret_cast<const __nv_bfloat162*>(&w);
      float x[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hw[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
      const bool ok = kbase + r < b.kend;
#pragma unroll
      for (int h = 0; h < GR; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qv[h][e], x[e], dot);
#pragma unroll
        for (int o = 1; o < LANES; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[i][h] = ok ? dot : kNegInf;
        mt[h] = fmaxf(mt[h], sc[i][h]);
      }
    }
    float alpha[GR];
#pragma unroll
    for (int h = 0; h < GR; ++h) {
      const float m_new = fmaxf(m[h], mt[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int r = KPW * warp + GPW * i + grp;
      const bool ok = kbase + r < b.kend;
      const uint4 w = *reinterpret_cast<const uint4*>(vs + sw<D>(r, sub));
      const __nv_bfloat162* hw = reinterpret_cast<const __nv_bfloat162*>(&w);
      float x[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hw[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int h = 0; h < GR; ++h) {
        const float p = ok ? expf(sc[i][h] - m[h]) : 0.f;
        l[h] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(p, x[e], acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* pacc = reinterpret_cast<float*>(ring);  // [NSUB][GR][D]
  const int j = warp * GPW + grp;
#pragma unroll
  for (int h = 0; h < GR; ++h) {
    if (sub == 0) {
      sm_m[j][h] = m[h];
      sm_l[j][h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      pacc[(j * GR + h) * D + 8 * sub + e] = acc[h][e];
  }
  __syncthreads();
  merge_and_store<D, GR, NSUB, NT>(a, b, sm_m, sm_l, sm_e, pacc);
}

// ---------------------------------------------------------------------------
// G > 2, fp32: f32 SIMT register tiles, the whole group a block
// ---------------------------------------------------------------------------
//   The bf16 routes' structure in IEEE f32 (tensor cores would mean TF32):
// a block owns one (slot, kv head, split) and MT m16 tiles of the group's
// query rows (all of them up to G = 64, so each K/V row is read once per
// (slot, kv head, split)), KQ warps a tile.  The split's keys stage in
// shared memory through a two-deep cp.async ring (K rows padded to D + 4
// floats, V rows of D) of 64 keys at D = 128 and 32 at 256; warp (tile mt,
// key group kq) runs the warp tile of flash_f32_tile.cuh over its 16 rows
// and its 1/KQ of each stage: at D = 128 and up to 3 tiles (granite's 48
// rows), KQ = 4 warps of 16 keys, a 4 x 2 score tile and a 4 x 16 output
// tile a lane, so 12 warps share an SM's work; at 4 tiles, for registers,
// KQ = 2 warps of 32 keys (4 x 4); at 256, KQ = 2 of 16 keys (4 x 2 and
// 4 x 32).  Q is staged
// once, scaled by D^-0.5 log2(e) (scores in the log2 domain).  At the end
// the key groups' (m, l, acc) merge in order through shared memory and the
// block writes the split's partial (its m in the log2 domain); the combine
// merges the splits in order with exp2.  Split widths are multiples of 64
// keys (``decode_geometry``): granite's group of 48 takes 64-key splits (one
// stage), 16 a slot, 3 tiles a block.  Measured by tools/flash_vs_parent.py
// on an NVIDIA H100 80GB HBM3 at 700 W: 0.0175 ms at granite's 8-slot cache
// (pass 1 0.0128 + combine 0.0028; flash_decode.cu's fp32 route 0.0340).

// keys of a ring stage by head dim, and the warps a stage's keys are split
// between: at D = 128 4 (16 keys a warp, a 4 x 2 score tile) up to 3 m16
// tiles a block, 2 (32 keys, 4 x 4) at 4 tiles, for registers; at 256, 2
template <int D>
constexpr int F32_TK = D == 128 ? 64 : 32;
template <int D, int MT>
constexpr int F32_KQ = D == 128 && MT <= 3 ? 4 : 2;
template <int D, int MT>
using F32DecTile = F32Tile<D, 4, 4, F32_TK<D> / F32_KQ<D, MT> / 8>;
constexpr int F32_TILES = 4;  // m16 tiles a block holds at most
constexpr int F32_SPLIT_UNIT = 64;  // a split is a multiple of this

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const int* pos;
  float* part;
  int H, groups, Smax, split, nsplit;
  long long q_sr, k_sslot, k_sseq, k_sh, v_sslot, v_sseq, v_sh;
  float scale;
};

template <int D, int MT>
constexpr int F32_NTH = 32 * MT * F32_KQ<D, MT>;  // threads of a block

template <int D, int MT>
constexpr int f32_smem() {
  using Tile = F32DecTile<D, MT>;
  return 4 * (MT * MROWS * Tile::LDQ + 2 * F32_TK<D> * (Tile::LDQ + D) +
              MT * F32_KQ<D, MT> * 16 * Tile::LDP);
}

template <int D, int MT>
__global__ void __launch_bounds__(F32_NTH<D, MT>)
gqa_decode_f32_kernel(const F32Args a) {
  using Tile = F32DecTile<D, MT>;
  constexpr int KQ = F32_KQ<D, MT>;
  constexpr int NTH = F32_NTH<D, MT>;
  constexpr int ROWS = MT * MROWS;
  constexpr int LDQ = Tile::LDQ;
  constexpr int TK = F32_TK<D>;
  constexpr int KW = Tile::KEYS;       // keys of a warp in a stage
  constexpr int STAGE = TK * (LDQ + D);  // floats of K then V
  static_assert(Tile::ROWS == MROWS && KW * KQ == TK, "warp tiling");
  static_assert((KQ - 1) * ROWS * (D + 2) <= 2 * STAGE, "merge space");
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                   // [ROWS][LDQ]
  float* ring = qs + ROWS * LDQ;     // 2 stages
  float* pbuf = ring + 2 * STAGE;    // [warps][16][LDP]

  const Block b = block_of<ROWS>(a);
  if (b.c0 >= b.kend) {  // no valid key here: the neutral partial
    neutral<D, NTH>(a, b);
    return;
  }
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int mt = warp / KQ;  // m16 tile
  const int kq = warp % KQ;  // key group of each stage
  const int lane = t & 31;
  const int rg = lane / Tile::TC;
  const int tc = lane % Tile::TC;
  constexpr int RG = Tile::NRG;
  constexpr int R = Tile::NR;
  const float* kb = a.k + b.slot * a.k_sslot + b.kvh * a.k_sh;
  const float* vb = a.v + b.slot * a.v_sslot + b.kvh * a.v_sh;

  // stage j's K and V rows (rows past kend land as zeros); one commit group
  auto load = [&](int j) {
    float* ks = ring + (j & 1) * STAGE;
    float* vs = ks + TK * LDQ;
    const int k0 = b.c0 + j * TK;
    for (int i = t; i < TK * (D / 4); i += NTH) {
      const int r = i / (D / 4);
      const int c = (i - r * (D / 4)) * 4;
      const int key = k0 + r;
      const bool ok = key < b.kend;
      const long long kk = ok ? key : 0;  // a valid address when zero-filling
      cp_async16(ks + r * LDQ + c, kb + kk * a.k_sseq + c, ok);
      cp_async16(vs + r * D + c, vb + kk * a.v_sseq + c, ok);
    }
    cp_async_commit();
  };

  const int ntiles = (b.kend - b.c0 + TK - 1) / TK;
  load(0);
  // Q [ROWS, D], scaled, while the first K/V rows are in flight (rows past
  // the group are zeros); any alignment, so element loads
  const float qscale = a.scale * 1.4426950408889634f;
  for (int i = t; i < ROWS * D; i += NTH) {
    const int r = i / D;
    const int d = i - r * D;
    qs[r * LDQ + d] =
        r < b.rows ? a.q[(b.row0 + r) * a.q_sr + d] * qscale : 0.f;
  }

  Tile tile;
  tile.init();
  int lim[R];
#pragma unroll
  for (int i = 0; i < R; ++i) lim[i] = b.kend;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // stage j (and Q) landed; stage j-1 is free
    if (j + 1 < ntiles) load(j + 1);
    const float* ks = ring + (j & 1) * STAGE + KW * kq * LDQ;
    const float* vs = ring + (j & 1) * STAGE + TK * LDQ + KW * kq * D;
    const int k0 = b.c0 + j * TK + KW * kq;
    if (k0 < b.kend) {
      float* ps = pbuf + warp * 16 * Tile::LDP;
      tile.scores(qs + 16 * mt * LDQ, ks, ps, k0, lim, k0 + KW > b.kend, 1.f,
                  rg, tc);
      tile.accumulate(vs, ps, rg, tc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: key groups 1.. leave results there
  tile.row_sums();

  // sub[kq - 1][row]: (m, l, acc) of key group kq; group 0 merges them in
  // order and writes the split's partial
  float* sub = ring;
  if (kq > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float* sr = sub + ((kq - 1) * ROWS + 16 * mt + rg + RG * i) * (D + 2);
      if (tc == 0) {
        sr[0] = tile.m[i];
        sr[1] = tile.l[i];
      }
#pragma unroll
      for (int e = 0; e < Tile::E; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sr[2 + 4 * Tile::TC * e + 4 * tc + c] = tile.acc[i][e][c];
    }
  }
  __syncthreads();
  if (kq == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = 16 * mt + rg + RG * i;
      if (r >= b.rows) continue;
      float mm = tile.m[i];
#pragma unroll
      for (int g = 1; g < KQ; ++g)
        mm = fmaxf(mm, sub[((g - 1) * ROWS + r) * (D + 2)]);
      float w[KQ];
      w[0] = exp2f(tile.m[i] - mm);
      float l = tile.l[i] * w[0];
#pragma unroll
      for (int g = 1; g < KQ; ++g) {
        const float* sr = sub + ((g - 1) * ROWS + r) * (D + 2);
        w[g] = exp2f(sr[0] - mm);
        l += sr[1] * w[g];
      }
      float* out = part_row<D>(a, b, r);
      if (tc == 0) {
        out[0] = mm;
        out[1] = l;
      }
#pragma unroll
      for (int e = 0; e < Tile::E; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = 4 * Tile::TC * e + 4 * tc + c;
          float x = tile.acc[i][e][c] * w[0];
#pragma unroll
          for (int g = 1; g < KQ; ++g)
            x += sub[((g - 1) * ROWS + r) * (D + 2) + 2 + d] * w[g];
          out[2 + d] = x;
        }
    }
  }
}

// Pass 2: out = sum_i acc_i e^(m_i - m) / max(sum_i l_i e^(m_i - m), 1e-30)
// over the splits in order, m = max_i m_i (2^ for the f32 route, whose m
// are in the log2 domain).  The block's threads first take
// m (a max: exact in any order), then the weights e^(m_i - m) of D splits
// at a time into shared memory, so that each thread's sums run over the
// splits in order with its loads in flight together.
template <int D, typename T, bool kLog2>
__global__ void __launch_bounds__(D)
gqa_decode_combine_kernel(const float* __restrict__ part,
                          T* __restrict__ o, int nsplit, long long o_sr) {
  __shared__ float red[D / 32];
  __shared__ float e_s[D], l_s[D];
  const int r = blockIdx.x;
  const int d = threadIdx.x;
  const float* pr = part + static_cast<long long>(r) * nsplit * (D + 2);
  float m = kNegInf;
  for (int i = d; i < nsplit; i += D) m = fmaxf(m, pr[i * (D + 2)]);
  m = block_max<D>(m, red);
  float l = 0.f;
  float acc = 0.f;
  for (int i0 = 0; i0 < nsplit; i0 += D) {
    const int n = min(D, nsplit - i0);
    if (d < n) {
      const float* pi = pr + (i0 + d) * (D + 2);
      e_s[d] = kLog2 ? exp2f(pi[0] - m) : expf(pi[0] - m);
      l_s[d] = pi[1];
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      l = fmaf(l_s[i], e_s[i], l);
      acc = fmaf(pr[(i0 + i) * (D + 2) + 2 + d], e_s[i], acc);
    }
    __syncthreads();
  }
  o[r * o_sr + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <auto Kernel, int SMEM, int NTH>
int launch_pass1(const Args& a, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = allow_smem<Kernel>(SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  Kernel<<<grid, NTH, SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// pass 1 on tensor cores with MT m16 tiles a block
template <int D, int MT>
int launch_mma(const Args& a, int S, cudaStream_t stream) {
  const int tiles = (a.groups + MROWS - 1) / MROWS;
  const dim3 grid((tiles + MT - 1) / MT, a.nsplit, S * (a.H / a.groups));
  return launch_pass1<gqa_decode_mma_kernel<D, MT>, mma_smem<D, MT>(),
                      NT * MT>(a, grid, stream);
}

template <int D>
int launch(const Args& a, int S, void* o, long long o_sr,
           cudaStream_t stream) {
  const int kv = a.H / a.groups;
  int rc;
  if (a.groups > 2) {
    if (a.split % Geo<D, true>::TK != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    // a block takes min(tiles, kMmaTiles) m16 tiles of the group
    const int mt = min((a.groups + MROWS - 1) / MROWS, kMmaTiles<D>);
    rc = mt == 1   ? launch_mma<D, 1>(a, S, stream)
         : mt == 2 ? launch_mma<D, 2>(a, S, stream)
                   : launch_mma<D, kMmaTiles<D>>(a, S, stream);
  } else {
    const dim3 grid(1, a.nsplit, S * kv);
    if (a.split % Geo<D, false>::TK != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    rc = a.groups == 2
             ? launch_pass1<gqa_decode_simt_kernel<D, 2>,
                            simt_smem<D>(), NT>(a, grid, stream)
             : launch_pass1<gqa_decode_simt_kernel<D, 1>,
                            simt_smem<D>(), NT>(a, grid, stream);
  }
  if (rc != 0) return rc;
  gqa_decode_combine_kernel<D, __nv_bfloat16, false>
      <<<S * a.H, D, 0, stream>>>(a.part, static_cast<__nv_bfloat16*>(o),
                                  a.nsplit, o_sr);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MT>
int launch_f32_mt(const F32Args& a, int S, cudaStream_t stream) {
  const int tiles = (a.groups + MROWS - 1) / MROWS;
  const dim3 grid((tiles + MT - 1) / MT, a.nsplit, S * (a.H / a.groups));
  constexpr int smem = f32_smem<D, MT>();
  const cudaError_t err = allow_smem<gqa_decode_f32_kernel<D, MT>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gqa_decode_f32_kernel<D, MT>
      <<<grid, F32_NTH<D, MT>, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const F32Args& a, int S, void* o, long long o_sr,
               cudaStream_t stream) {
  // a block takes min(tiles, F32_TILES) m16 tiles of the group
  const int mt = min((a.groups + MROWS - 1) / MROWS, F32_TILES);
  const int rc = mt == 1   ? launch_f32_mt<D, 1>(a, S, stream)
                 : mt == 2 ? launch_f32_mt<D, 2>(a, S, stream)
                 : mt == 3 ? launch_f32_mt<D, 3>(a, S, stream)
                           : launch_f32_mt<D, F32_TILES>(a, S, stream);
  if (rc != 0) return rc;
  gqa_decode_combine_kernel<D, float, true><<<S * a.H, D, 0, stream>>>(
      a.part, static_cast<float*>(o), a.nsplit, o_sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// bf16, head dims 128 and 256 (dk == dv).  ``split`` keys a pass-1 block
// and ``nsplit`` = ceil(Smax / split) come from
// ``flash_attn.decode_geometry``; ``part`` is the f32 scratch [S*H, nsplit,
// D + 2].  The wrapper has checked that k and v are 16-byte aligned with
// strides of whole 16-byte words.
extern "C" int repro_flash_decode_gqa(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* part, void* o, int S, int H,
                                      int D, int groups, int Smax, int split,
                                      int nsplit, long long q_sr,
                                      long long k_sslot, long long k_sseq,
                                      long long k_sh, long long v_sslot,
                                      long long v_sseq, long long v_sh,
                                      long long o_sr, float scale,
                                      void* stream) {
  using namespace repro;
  if (S <= 0 || groups <= 0 || H % groups != 0 || Smax <= 0 || split <= 0 ||
      nsplit <= 0 || nsplit > 65535 ||
      static_cast<long long>(nsplit) * split < Smax ||
      static_cast<long long>(nsplit - 1) * split >= Smax ||
      static_cast<long long>(S) * (H / groups) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int*>(pos),
               static_cast<float*>(part),
               H, groups, Smax, split, nsplit, q_sr, k_sslot, k_sseq, k_sh,
               v_sslot, v_sseq, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(a, S, o, o_sr, st);
  if (D == 256) return launch<256>(a, S, o, o_sr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32, head dims 128 and 256, groups over 2 (dk == dv): the arguments of
// repro_flash_decode_gqa; ``split`` is a multiple of 64 keys.
extern "C" int repro_flash_decode_gqa_f32(const void* q, const void* k,
                                          const void* v, const void* pos,
                                          void* part, void* o, int S, int H,
                                          int D, int groups, int Smax,
                                          int split, int nsplit,
                                          long long q_sr, long long k_sslot,
                                          long long k_sseq, long long k_sh,
                                          long long v_sslot, long long v_sseq,
                                          long long v_sh, long long o_sr,
                                          float scale, void* stream) {
  using namespace repro;
  if (S <= 0 || groups <= 2 || H % groups != 0 || Smax <= 0 || split <= 0 ||
      split % F32_SPLIT_UNIT != 0 || nsplit <= 0 || nsplit > 65535 ||
      static_cast<long long>(nsplit) * split < Smax ||
      static_cast<long long>(nsplit - 1) * split >= Smax ||
      static_cast<long long>(S) * (H / groups) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const int*>(pos),
                  static_cast<float*>(part), H, groups, Smax, split, nsplit,
                  q_sr, k_sslot, k_sseq, k_sh, v_sslot, v_sseq, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_f32<128>(a, S, o, o_sr, st);
  if (D == 256) return launch_f32<256>(a, S, o, o_sr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
