// Flash-attention prefill on Hopper tensor cores (sm_90a), bf16: the port
// of the TPU kernel ``flash_attention`` in src/repro/kernels/flash_attn.py
// (body ``_flash_kernel``).  The fp32 route stays the scalar kernel in
// flash_prefill.cu.
//
// Computes, for every (batch*head) row block, causal or full online-softmax
// attention: scores in f32 scaled by dk^-0.5, masked entries at -1e30, a
// running (m, l, acc) in f32, l clamped at 1e-30, output in bf16.  GQA:
// query head ``bh`` reads kv head ``bh / groups`` (never a repeated copy).
//
// Design.  One block of one warpgroup (128 threads) per (bh, 64-row query
// tile); the grid puts every head's last (longest causal) tile first.
// Thread 0 loads the Q tile once and 64-key K/V tiles into a two-stage ring
// with TMA (3-D tensor maps over the caller's strides, 128-byte swizzle: a
// 64-element bf16 row is exactly 128 bytes), completion on mbarriers; tile
// j+2 is requested as soon as tile j has been consumed.  Head dims 128 and
// 256 cut every tile into D/64 column chunks of 64 x 64 (one TMA box and
// one swizzle atom each), so each chunk is laid out as a whole tile at 64.
//   S = Q K^T is D/16 wgmma m64n64k16 (bf16 in, f32 out), both operands
// K-major in shared memory; k-step kk reads chunk kk/4 at column 16(kk%4).
// bf16 x bf16 products are exact in f32; the scale D^-0.5 multiplies S
// (an exact power of two at 64 and 256, one f32 rounding at 128).
//   The online softmax works on the accumulator fragment: a thread holds
// 16 scores of each of two rows, a row lives on a quad of lanes, so row
// max/sum are two quad shuffles.  Tiles wholly below the diagonal skip the
// mask; the diagonal tile masks per element, tiles above it are never
// loaded; a ragged Sk is masked by position (TMA's zero fill is a score of
// 0, not a masked one) and a ragged Sq by the store.
//   O += P V keeps f32 accuracy with bf16 tensor cores by splitting P into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi): two register-A wgmma (the
// accumulator layout of S is the A-fragment layout) against the V tile,
// which is MN-major ([keys, d] as stored), so B is transposed; one
// m64n64k16 per 64-column chunk of V, each into its own accumulator
// (acc[D/64][32]: 128 registers a thread at D = 256).  A single bf16 P
// would miss the one-ulp check against the f32 plain version by ~2e-3;
// hi/lo leaves ~1e-6.
//
// Bound.  At the main path's shape (q/k/v [32, L, 64] bf16, causal) the
// bytes (4*BH*L*D*2; 8.4 MB at L = 512, ~2.5 us at 3.35 TB/s) bound it
// ahead of the tensor-core work (3 products of BH*L^2/2*D*2 FLOPs with the
// split, ~0.3 us at 989 TFLOP/s).  What stands between this design and the
// bound is latency: one warpgroup per block waits on each tile's TMA,
// QK^T, softmax and PV in turn, with no second consumer to overlap them.
#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int DC = 64;         // columns of a chunk: one 128-byte row
constexpr int BQ = 64;         // query rows per block: one wgmma M
constexpr int BK = 64;         // keys per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int NT = 128;        // one warpgroup
constexpr int CHUNK = BQ * DC;  // elements of a 64 x 64 chunk (8 KB)

template <int D>
struct Smem {  // at a 1024-B aligned base: every chunk is 1024-B aligned
  static constexpr int NC = D / DC;
  __nv_bfloat16 q[NC][CHUNK];
  __nv_bfloat16 k[STAGES][NC][CHUNK];
  __nv_bfloat16 v[STAGES][NC][CHUNK];
  uint64_t bar_q;
  uint64_t bar_k[STAGES];
  uint64_t bar_v[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase with parity ``parity``.
// A tile that never lands (a bad tensor map) traps after ~2^34 cycles
// (seconds) instead of hanging the card; a real wait is microseconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) break;
    const long long now = clock64();
    if (start == 0) start = now;
    else if (now - start > (1LL << 34)) __trap();
  }
  __syncwarp();  // the warpgroup's wgmma that follow run converged
}

// One box of the 3-D map at coordinates (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows stored with the
// 128-byte swizzle: start address >> 4, LBO (unused by these layouts; 1),
// SBO = 1024 B between 8-row groups, layout type 1 (B128).  Tiles start
// 1024-B aligned, so the base offset is 0; a k-step inside the swizzle
// atom advances the start address (as CUTLASS's descriptor iterator does).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  uint64_t d = static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;           // LBO
  d |= static_cast<uint64_t>(1024 >> 4) << 32;   // SBO
  d |= static_cast<uint64_t>(1) << 62;           // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define REPRO_D32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define REPRO_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d[64x64] (+)= A[64x16] B[16x64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}\n"
      : REPRO_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] B[16x64]; A in registers (4 x bf16x2 per thread),
// B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}\n"
      : REPRO_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_D32
#undef REPRO_R32

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// Coordinates of tile row ``row`` of head ``head`` in a map whose outer
// dims are (rows, heads), or (heads, rows) when ``swap``.
struct Coord {
  int c1, c2;
};
__device__ __forceinline__ Coord coord(int row, int head, int swap) {
  return swap ? Coord{head, row} : Coord{row, head};
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_prefill_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                          int groups, int causal, int swap_q, int swap_k,
                          int swap_v, long long o_sbh, long long o_ss,
                          float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + pad);
  constexpr int NC = D / DC;
  constexpr uint32_t TILE_BYTES = BQ * D * 2;   // 64 rows of 2D bytes

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int kvh = bh / groups;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8
  const int c_lo = 2 * (lane & 3);           // + 8j + {0, 1}: columns
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  auto load_kv = [&](int j) {
    const int s = j % STAGES;
    const Coord ck = coord(j * BK, kvh, swap_k);
    const Coord cv = coord(j * BK, kvh, swap_v);
    mbar_expect_tx(&sm.bar_k[s], TILE_BYTES);
    for (int c = 0; c < NC; ++c)
      tma_load(sm.k[s][c], &mk, &sm.bar_k[s], DC * c, ck.c1, ck.c2);
    mbar_expect_tx(&sm.bar_v[s], TILE_BYTES);
    for (int c = 0; c < NC; ++c)
      tma_load(sm.v[s][c], &mv, &sm.bar_v[s], DC * c, cv.c1, cv.c2);
  };

  if (t == 0) {
    mbar_init(&sm.bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.bar_k[s], 1);
      mbar_init(&sm.bar_v[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    const Coord cq = coord(q0, bh, swap_q);
    mbar_expect_tx(&sm.bar_q, TILE_BYTES);
    for (int c = 0; c < NC; ++c)
      tma_load(sm.q[c], &mq, &sm.bar_q, DC * c, cq.c1, cq.c2);
    for (int j = 0; j < STAGES && j < n_kt; ++j) load_kv(j);
  }

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  mbar_wait(&sm.bar_q, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int k0 = j * BK;

    // -- S = Q K^T ----------------------------------------------------------
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(&sm.bar_k[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, sw128_desc(sm.q[kk / 4] + (kk % 4) * 16),
               sw128_desc(sm.k[s][kk / 4] + (kk % 4) * 16), kk > 0);
    wg_commit();
    wg_wait_all();

    // -- online softmax on the fragment: sc[i] is row r_lo + 8*((i>>1)&1),
    //    column k0 + 8*(i>>2) + c_lo + (i&1) --------------------------------
    const bool masked_tile = (causal && k0 + BK - 1 > q0) || k0 + BK > Sk;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (masked_tile) {
        const int col = k0 + 8 * (i >> 2) + c_lo + (i & 1);
        const int row = q0 + r_lo + 8 * h;
        if (col >= Sk || (causal && col > row)) x = kNegInf;
      }
      sc[i] = x;
      mt[h] = fmaxf(mt[h], x);
    }
    float alpha[2], m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      m_new[h] = fmaxf(m[h], mt[h]);
      alpha[h] = expf(m[h] - m_new[h]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      bool ok = true;
      if (masked_tile) {
        const int col = k0 + 8 * (i >> 2) + c_lo + (i & 1);
        const int row = q0 + r_lo + 8 * h;
        ok = col < Sk && !(causal && col > row);
      }
      const float p = ok ? expf(sc[i] - m_new[h]) : 0.f;
      sc[i] = p;
      ps[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = l[h] * alpha[h] + ps[h];
      m[h] = m_new[h];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

    // -- O += P_hi V + P_lo V: the S fragment of keys [16kk, 16kk+16) is
    //    the A fragment of k-step kk ------------------------------------------
    uint32_t a_hi[16], a_lo[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float x0 = sc[2 * r];
      const float x1 = sc[2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      a_hi[r] = pack_bf16(hi);
      a_lo[r] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
    mbar_wait(&sm.bar_v[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dv = sw128_desc(sm.v[s][c] + kk * 16 * DC);
        wgmma_rs(acc[c], a_hi + 4 * kk, dv);
        wgmma_rs(acc[c], a_lo + 4 * kk, dv);
      }
    }
    wg_commit();
    wg_wait_all();

    __syncthreads();  // every warp is done reading stage s
    if (t == 0 && j + STAGES < n_kt) load_kv(j + STAGES);
  }

  // -- epilogue: acc / max(l, 1e-30) in bf16, ragged Sq masked -------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r_lo + 8 * h;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* op = o + bh * o_sbh + static_cast<long long>(row) * o_ss;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = 4 * c + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(op + DC * cc + 8 * c + c_lo) =
            __floats2bfloat162_rn(acc[cc][i] / lc, acc[cc][i + 1] / lc);
      }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of 64x64 boxes over a bf16 [heads, rows, D] tensor with element
// strides (s_head, s_row, 1), 128-byte swizzle, zero fill out of bounds; a
// row of D > 64 is D/64 boxes side by side.  The two outer dims go in
// ascending stride order; ``swap`` says that heads come before rows.
bool encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                int D, int heads, int rows, long long s_head, long long s_row,
                int* swap) {
  *swap = s_head < s_row;
  const cuuint64_t dims[3] = {
      static_cast<cuuint64_t>(D),
      static_cast<cuuint64_t>(*swap ? heads : rows),
      static_cast<cuuint64_t>(*swap ? rows : heads)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>((*swap ? s_head : s_row) * 2),
      static_cast<cuuint64_t>((*swap ? s_row : s_head) * 2)};
  const cuuint32_t box[3] = {DC, *swap ? 1u : 64u, *swap ? 64u : 1u};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const EncodeTiledFn enc, const void* q, const void* k,
           const void* v, void* o, int BH, int Sq, int Sk, int groups,
           int causal, long long q_sbh, long long q_ss, long long k_sbh,
           long long k_ss, long long v_sbh, long long v_ss, long long o_sbh,
           long long o_ss, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  int swap_q = 0, swap_k = 0, swap_v = 0;
  if (!encode_map(enc, &mq, q, D, BH, Sq, q_sbh, q_ss, &swap_q))
    return static_cast<int>(cudaErrorInvalidValue);
  // With Sk == 0 no K/V tile is ever requested, so those maps stay empty.
  if (Sk > 0 &&
      (!encode_map(enc, &mk, k, D, BH / groups, Sk, k_sbh, k_ss, &swap_k) ||
       !encode_map(enc, &mv, v, D, BH / groups, Sk, v_sbh, v_ss, &swap_v)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, n_qt);
  const int smem = static_cast<int>(sizeof(Smem<D>)) + 1024;  // + alignment
  const cudaError_t err = allow_smem<flash_prefill_sm90_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_sm90_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Sk, groups, causal,
      swap_q, swap_k, swap_v, o_sbh, o_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// bf16, head dims 64, 128 and 256 (dk == dv).  The wrapper has checked
// TMA's conditions: 16-byte aligned bases, strides (in elements) whose byte
// size is a multiple of 16, a contiguous last dim.
extern "C" int repro_flash_prefill_sm90(const void* q, const void* k,
                                        const void* v, void* o, int BH,
                                        int Sq, int Sk, int D, int groups,
                                        int causal, long long q_sbh,
                                        long long q_ss, long long k_sbh,
                                        long long k_ss, long long v_sbh,
                                        long long v_ss, long long o_sbh,
                                        long long o_ss, float scale,
                                        void* stream) {
  using namespace repro;
  if (BH <= 0 || Sq <= 0 || Sk < 0 || groups <= 0 || BH % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SM90(DD)                                                     \
  launch<DD>(enc, q, k, v, o, BH, Sq, Sk, groups, causal, q_sbh, q_ss,     \
             k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss, scale, st)
  if (D == 64) return REPRO_SM90(64);
  if (D == 128) return REPRO_SM90(128);
  if (D == 256) return REPRO_SM90(256);
#undef REPRO_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}
