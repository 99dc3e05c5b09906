// One warp's share of an f32 online-softmax attention tile, for head dims
// 128 and 256 on the CUDA cores (IEEE f32 FMAs; tensor cores would mean
// TF32, which the fp32 tolerance of atol = rtol = 2e-5 refuses).  K5's
// fp32 kernel at those dims (flash_prefill.cu) and K6's grouped-head fp32
// kernel (flash_decode_gqa.cu) both run it.
//
// What bounds it.  An SM issues 4 warp-wide FMAs a clock but serves one
// 128-byte shared-memory wavefront a clock: a warp's 128-bit load takes
// four when its quarter-warps read distinct 16-byte words, two when each
// quarter-warp reads at most two (a broadcast; tools/smem_probe.py measures
// it on the card).  So the FMA pipe sets the pace only where the FMAs
// outnumber 4 x the wavefronts; below that the shared pipe does.  Register
// tiles raise the ratio: a lane that owns R rows and C keys loads R
// (broadcast) Q and C K float4s per 4 dims of Q K^T for 4 R C FMAs, and R
// (broadcast) P and D/TC V float4s per 4 keys of P V for 4 R D/TC FMAs.
// Each phase loads the next step's float4s while this step's FMAs run, so
// a warp need not wait out each load's latency.
//
// Layout.  The warp's lanes form RG row groups of TC = 32 / RG lanes; lane
// (rg = lane / TC, tc = lane % TC) owns rows rg + RG i (i < R), the scores
// of keys tc + TC j (j < C) and the output dims 4 tc + 4 TC e (e < E =
// D / (4 TC), four each): an R x C score tile and an R x 4E output tile in
// registers, over RG R rows and TC C keys a warp.  Row pitches keep every
// load and store free of bank conflicts beyond its unique bytes: Q and K
// rows of D + 4 floats (a quarter-warp's 8 key rows, or its one query row,
// fall in distinct 4-bank groups), V rows of D (a quarter-warp reads 128
// contiguous bytes), P rows of TC (C + 1) (the RG row groups' scalar stores
// land in distinct banks; a quarter-warp's float4 reads are one row).
//
// Scores are taken in the log2 domain (q.k times ``scale``, where the
// caller folds log2(e) into it, then exp2f); keys at or past a row's limit
// score -1e30 and weigh exactly 0.  The row max is reduced over the TC
// lanes of a row with shuffles; the row sum stays a per-lane partial until
// ``row_sums`` (its rescale factor is the same on the TC lanes).
#pragma once

#include "common.cuh"

namespace repro {

template <int D, int RG, int R, int C>
struct F32Tile {
  static constexpr int NRG = RG;            // row groups of the warp
  static constexpr int NR = R;              // rows of a lane
  static constexpr int TC = 32 / RG;        // lanes of a row group
  static constexpr int E = D / (4 * TC);    // float4 groups of output dims
  static constexpr int ROWS = RG * R;       // rows of the warp
  static constexpr int KEYS = TC * C;       // keys of the warp
  static constexpr int LDQ = D + 4;         // Q and K row pitch (floats)
  static constexpr int LDV = D;
  static constexpr int LDP = TC * (C + 1);
  static_assert(D == 128 || D == 256, "head dims 128 and 256");
  static_assert(RG * TC == 32 && E >= 1 && KEYS % 8 == 0, "layout");

  float m[R], l[R];
  float acc[R][E][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][e][c] = 0.f;
    }
  }

  static __device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }

  static __device__ __forceinline__ float comp(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }

  // Q K^T and the online softmax for one tile: ``qs`` is the warp's query
  // row 0 (pitch LDQ), ``ks`` its key 0 (pitch LDQ), ``ps`` its rows of P
  // (pitch LDP); ``k0`` is the global index of key 0; row i's keys must be
  // below ``lim[i]``, checked only when ``masked`` (some key of the tile is
  // at or past some row's limit).  Rescales the output tile and leaves P.
  // The next 4 dims' Q and K float4s load while this 4's FMAs run (the
  // last prefetch reads the rows' padding).
  __device__ __forceinline__ void scores(const float* qs, const float* ks,
                                         float* ps, int k0,
                                         const int (&lim)[R], bool masked,
                                         float scale, int rg, int tc) {
    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
    float4 qv[2][R], kv[2][C];
    const float* qr = qs + rg * LDQ;
    const float* kr = ks + tc * LDQ;
    auto load = [&](int b, int d) {
#pragma unroll
      for (int i = 0; i < R; ++i) qv[b][i] = ld4(qr + RG * i * LDQ + d);
#pragma unroll
      for (int j = 0; j < C; ++j) kv[b][j] = ld4(kr + TC * j * LDQ + d);
    };
    auto fma4 = [&](int b) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          float a = s[i][j];
          a = fmaf(qv[b][i].x, kv[b][j].x, a);
          a = fmaf(qv[b][i].y, kv[b][j].y, a);
          a = fmaf(qv[b][i].z, kv[b][j].z, a);
          a = fmaf(qv[b][i].w, kv[b][j].w, a);
          s[i][j] = a;
        }
    };
    load(0, 0);
#pragma unroll 1
    for (int d = 0; d < D; d += 8) {
      load(1, d + 4);
      fma4(0);
      load(0, d + 8);
      fma4(1);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float x = s[i][j] * scale;
        if (masked && k0 + tc + TC * j >= lim[i]) x = kNegInf;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int o = 1; o < TC; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float p = exp2f(s[i][j] - m_new);
        if (masked && k0 + tc + TC * j >= lim[i]) p = 0.f;
        psum += p;
        ps[(rg + RG * i) * LDP + tc + TC * j] = p;
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][e][c] *= alpha;
    }
    __syncwarp();  // this warp's rows of P are written
  }

  // acc += P V for the tile ``scores`` left in ``ps``; ``vs`` is the
  // warp's key 0 (pitch LDV).  Keys in order; the next key's V float4s
  // (and the next 4 keys' P float4s) load while this key's FMAs run, where
  // the registers allow.
  __device__ __forceinline__ void accumulate(const float* vs, const float* ps,
                                             int rg, int tc) {
    constexpr bool kPipeV = R * E <= 16;
    float4 pv[2][R], vv[2][E];
    const float* pr = ps + rg * LDP;
    const float* vr = vs + 4 * tc;
    auto load_p = [&](int b, int kk) {
#pragma unroll
      for (int i = 0; i < R; ++i) pv[b][i] = ld4(pr + RG * i * LDP + kk);
    };
    auto load_v = [&](int b, int key) {
#pragma unroll
      for (int e = 0; e < E; ++e) vv[b][e] = ld4(vr + key * LDV + 4 * TC * e);
    };
    load_p(0, 0);
    if (kPipeV) load_v(0, 0);
#pragma unroll 1
    for (int kk = 0; kk < KEYS; kk += 8) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int key = kk + c;
        if (c == 0) load_p(1, kk + 4);
        if (c == 4) load_p(0, min(kk + 8, KEYS - 4));
        const int vb = kPipeV ? c & 1 : 0;
        if (kPipeV)
          load_v((c + 1) & 1, min(key + 1, KEYS - 1));
        else
          load_v(0, key);
        const int pb = c >> 2;
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float p = comp(pv[pb][i], c & 3);
            acc[i][e][0] = fmaf(p, vv[vb][e].x, acc[i][e][0]);
            acc[i][e][1] = fmaf(p, vv[vb][e].y, acc[i][e][1]);
            acc[i][e][2] = fmaf(p, vv[vb][e].z, acc[i][e][2]);
            acc[i][e][3] = fmaf(p, vv[vb][e].w, acc[i][e][3]);
          }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

  // the per-lane partial row sums -> the rows' sums, on every lane
  __device__ __forceinline__ void row_sums() {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int o = 1; o < TC; o <<= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  }
};

}  // namespace repro
