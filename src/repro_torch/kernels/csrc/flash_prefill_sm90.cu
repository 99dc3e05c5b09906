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
// Head dim 64: one block of one warpgroup (128 threads) per (bh, 64-row
// query tile); the grid puts every head's last (longest causal) tile first.
// Thread 0 loads the Q tile once and 64-key K/V tiles into a two-stage ring
// with TMA (3-D tensor maps over the caller's strides, 128-byte swizzle: a
// 64-element bf16 row is exactly 128 bytes), completion on mbarriers; tile
// j+2 is requested as soon as tile j has been consumed.
//   S = Q K^T is D/16 wgmma m64n64k16 (bf16 in, f32 out), both operands
// K-major in shared memory; k-step kk reads 64-column chunk kk/4 at column
// 16(kk%4).  bf16 x bf16 products are exact in f32; the scale D^-0.5
// multiplies S (an exact power of two at 64 and 256, one f32 rounding at
// 128).
//   The online softmax works on the accumulator fragment: a thread holds
// 2 scores of each 8-key column group of two rows, a row lives on a quad of
// lanes, so row max/sum are two quad shuffles.  Tiles wholly below the
// diagonal skip the mask; the diagonal tile masks per element, tiles above
// it are never loaded; a ragged Sk is masked by position (TMA's zero fill
// is a score of 0, not a masked one) and a ragged Sq by the store.
//   O += P V keeps f32 accuracy with bf16 tensor cores by splitting P into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi): two register-A wgmma (the
// accumulator layout of S is the A-fragment layout) against the V tile,
// which is MN-major ([keys, d] as stored), so B is transposed; one
// m64n64k16 per 64-column chunk of V, each into its own accumulator.  A
// single bf16 P would miss the one-ulp check against the f32 plain version
// by ~2e-3; hi/lo leaves ~1e-6.
//
// Head dims 128 and 256 (granite, mixtral, qwen, internvl2; gemma3's global
// layers): warp-specialised, 384 threads a block.  Warpgroup 0 gives its
// registers away (setmaxnreg 24) and one of its threads keeps TMA loads of K/V
// in flight into a ring (full and free mbarriers a stage, K's apart from V's,
// so that K of a later tile loads while P V of this one runs). Warpgroups 1 and
// 2 (setmaxnreg 240) are the consumers.  At D = 128 they take 64 query rows
// each of a 128-row tile and share every K/V tile (128 keys, QK^T one
// m64n128k16 a k-step, a two-stage ring); at D = 256 they take the same 64 rows
// and split the key tiles (64 keys, even and odd, a three-stage ring), then
// merge their (m, l, acc), because 128-row tiles of gemma3's 8 heads leave half
// the SMs idle.  Each consumer runs a software pipeline: one batch of wgmma
// issues S_j = Q K_j^T and O += P_i V_i of its previous tile; the softmax of
// S_j runs while that P V completes; then O is rescaled and P_j split.  The
// softmax, not the tensor cores, sets the pace here, so it is kept lean: the
// row max on the raw scores, the running max in log2 units, p = ex2.approx(s c
// - m) as one FFMA and one SFU op, masks only on the tiles that cross the
// diagonal or Sk (with expf it ran slower than the one-warpgroup design), and
// the running max moves (and O is rescaled) only when a tile's max passes it by
// more than 2^8.  O += P V is one wgmma a k-step over all D columns (m64n128k16
// / m64n256k16, V's 64-column chunks one operand through the descriptor's
// leading byte offset).  The consumers take turns issuing their batch
// (ping-pong on named barriers 1 and 2), so one's softmax overlaps the other's
// products.  With shared rows both consumers run every key tile of the block
// (the upper one's last may be fully masked: p = 0 leaves (m, l, acc) as they
// were), so turns and stage releases pair up, also when a ragged Sq leaves one
// with no rows (its output is not stored). The kernel's waits have no timeout:
// any trap in it keeps ptxas from giving the consumers their 240 registers
// (ws_wait).
//
// Bound.  The operations of attention (QK^T and PV: 4 BH D L^2/2 FLOPs,
// causal) at 989 TFLOP/s bound the wide head dims at L >= 512 (granite
// [48, 1024, 128]: 13 us), the bytes (4 BH L D 2 at 3.35 TB/s) the short
// ones; the hi/lo split adds a third product on top of that bound.  At
// 128 and 256 the softmax's per-score work, not the tensor cores, sets the
// pace (PERF.md §6).  At d = 64 the one-warpgroup kernel waits on each
// tile's TMA, QK^T, softmax and PV in turn.
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

// sw128_desc with a leading byte offset: for an MN-major operand wider
// than one 64-element swizzle atom, the bytes between its 64-column chunks
__device__ __forceinline__ uint64_t sw128_desc_lbo(const void* p,
                                                   uint32_t lbo) {
  return (sw128_desc(p) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16);
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
// at most N of this warpgroup's committed wgmma groups still pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
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

// d[64x128] (+)= A[64x16] B[16x128]; A and B K-major in shared memory (B:
// 128 rows of 128 bytes, 8-row groups 1024 B apart).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x128] += A[64x16] B[16x128]; A in registers, B MN-major in shared
// memory as 64-column chunks of the 128-byte swizzle ``lbo`` bytes apart
// (the descriptor's leading byte offset).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x256] += A[64x16] B[16x256]; A in registers, B MN-major in shared
// memory as 64-column chunks of the 128-byte swizzle ``lbo`` bytes apart
// (the descriptor's leading byte offset).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %133, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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

// ---------------------------------------------------------------------------
// Head dims 128 and 256: warp-specialised, two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int WS_NT = 384;         // producer warpgroup + two consumers
constexpr int BAR_TURN = 1;        // named barriers 1 and 2: the turns
constexpr int BAR_MERGE = 3;       // named barrier 3: the consumers' merge

// The consumers' split of a block's work.  Shared rows (D = 128, SPLIT
// false): each takes 64 of the block's 128 query rows and both read every
// K/V tile, so granite's 48 heads pull half the K/V bytes through L2.
// Split keys (D = 256, SPLIT true): both take the block's 64 rows,
// consumer c the key tiles j with j % 2 == c, and they merge (m, l, acc)
// at the end: gemma3's 8 heads in 128-row tiles would fill half the SMs
// (32 blocks at L = 512).
template <int D>
struct Ws {
  static constexpr bool SPLIT = D == 256;
  static constexpr int NC = D / DC;
  // keys a tile: 128 at D = 128 (QK^T one m64n128k16 a k-step), 64 at
  // D = 256 (the output accumulator already holds 128 registers a thread)
  static constexpr int BK = D == 128 ? 128 : 64;
  static constexpr int BQ = SPLIT ? 64 : 128;   // query rows a block
  static constexpr int STAGES = SPLIT ? 3 : 2;  // K/V ring depth
  static constexpr int NS = BK / 2;   // score registers a thread
  static constexpr int NP = BK / 4;   // packed P registers (hi, and lo)
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
};

template <int D>
struct SmemWs {  // at a 1024-B aligned base: every chunk is 1024-B aligned
  using W = Ws<D>;
  __nv_bfloat16 q[W::NC][W::BQ * DC];        // shared rows: 64 a consumer
  __nv_bfloat16 k[W::STAGES][W::NC][W::BK * DC];
  __nv_bfloat16 v[W::STAGES][W::NC][W::BK * DC];
  uint64_t bar_q;
  uint64_t bar_k[W::STAGES];
  uint64_t bar_v[W::STAGES];
  // the consumers of a tile are done with its K (after QK^T) or its V
  // (after P V): the K of a later tile loads while P V of this one runs
  uint64_t bar_k_free[W::STAGES];
  uint64_t bar_v_free[W::STAGES];
};

// The warp-specialised kernel's wait: polls until the phase with parity
// ``parity`` completes.  It has no timeout: a trap anywhere in the kernel
// (mbar_wait's clock64 bound, or a count of polls) keeps ptxas from giving
// the consumers the registers that setmaxnreg grants (they spill, and
// their wgmma serialise).  The turn and stage protocol is held by the cuda
// tests at ragged shapes.  The consumers' waits end in a warp barrier:
// their wgmma run converged.
__device__ __forceinline__ void ws_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

__device__ __forceinline__ void ws_wait_warp(uint64_t* bar, uint32_t parity) {
  ws_wait(bar, parity);
  __syncwarp();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Named barrier ``id`` over both consumer warpgroups (256 threads): one
// waits for its turn, the other arrives to give it.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_give(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Keep ``x`` in its register across the asynchronous wgmma that reads or
// writes it (no move, no reordering across this point).
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i]) :: "memory");
}

// O += P_hi V + P_lo V for the tile in V stage ``vs`` (P in a_hi/a_lo: the
// S fragment of keys [16kk, 16kk+16) is the A fragment of k-step kk); one
// wgmma a k-step spans all D output columns (the NC chunks of V as one
// operand), into the flat accumulator acc[NC * 32].
template <int NC, int BK>
__device__ __forceinline__ void issue_pv(
    float (&acc)[NC * 32], const uint32_t (&a_hi)[BK / 4],
    const uint32_t (&a_lo)[BK / 4], const __nv_bfloat16 (&vs)[NC][BK * DC]) {
  constexpr uint32_t kChunkBytes = BK * DC * 2;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc_lbo(vs[0] + kk * 16 * DC, kChunkBytes);
    if constexpr (NC == 2) {
      wgmma_rs_n128(acc, a_hi + 4 * kk, dv);
      wgmma_rs_n128(acc, a_lo + 4 * kk, dv);
    } else {
      wgmma_rs_n256(acc, a_hi + 4 * kk, dv);
      wgmma_rs_n256(acc, a_lo + 4 * kk, dv);
    }
  }
}

// 2^x on the SFU, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile on the S fragment (NS scores a
// thread): sc[i] is row r_lo + 8((i>>1)&1) of the warpgroup's rows from
// row0, column k0 + 8(i>>2) + c_lo + (i&1).  The running max m is kept in
// log2 units of the scaled score, so p = 2^(s scale log2(e) - m) is one
// FFMA and one ex2.  Updates (m, l), leaves p in sc and the output's
// rescale in alpha; returns whether the warp's max moved (the rescale is
// needed).  Masked entries are -1e30 before the max and p = 0 after it; a
// tile wholly masked for a row leaves its (m, l) as they were.
template <int NS>
__device__ __forceinline__ bool ws_softmax(float (&sc)[NS], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           int k0, int bk, int row0,
                                           int r_lo, int c_lo, int Sk,
                                           int causal, float scale) {
  const bool masked_tile = (causal && k0 + bk - 1 > row0) || k0 + bk > Sk;
  const float scale2 = scale * 1.4426950408889634f;
  if (masked_tile) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = k0 + 8 * (i >> 2) + c_lo + (i & 1);
      const int row = row0 + r_lo + 8 * ((i >> 1) & 1);
      if (col >= Sk || (causal && col > row)) sc[i] = kNegInf;
    }
  }
  float mt[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
  // the running max moves only when a row's tile max passes it by more
  // than 8 (p stays below 2^8 in between): a warp rescales its output
  // rows together, and most tiles past the first few rescale nothing
  bool grow = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
    mt[h] *= scale2;
    grow |= mt[h] > m[h] + 8.f;
  }
  grow = __any_sync(0xffffffffu, grow);
  float nm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alpha[h] = 1.f;
    if (grow) {
      const float m_new = fmaxf(m[h], mt[h]);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
    nm[h] = -m[h];
  }
  float ps[2] = {0.f, 0.f};
  if (masked_tile) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      const float p = sc[i] == kNegInf ? 0.f : ex2(fmaf(sc[i], scale2, nm[h]));
      sc[i] = p;
      ps[h] += p;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(fmaf(sc[i], scale2, nm[h]));
      sc[i] = p;
      ps[h] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
    ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
    l[h] = l[h] * alpha[h] + ps[h];
  }
  return grow;
}

// acc *= alpha by row (when the max grew); P (in sc) split into bf16 hi
// and lo A fragments
template <int NC, int NS>
__device__ __forceinline__ void ws_rescale_split(float (&acc)[NC * 32],
                                                 const float (&alpha)[2],
                                                 bool grow,
                                                 const float (&sc)[NS],
                                                 uint32_t (&a_hi)[NS / 2],
                                                 uint32_t (&a_lo)[NS / 2]) {
  if (grow) {
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
#pragma unroll
  for (int r = 0; r < NS / 2; ++r) {
    const float x0 = sc[2 * r];
    const float x1 = sc[2 * r + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(hi);
    a_hi[r] = pack_bf16(hi);
    a_lo[r] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
  }
}

// One consumer warpgroup: its query rows [row0, row0 + 64) against its
// key tiles j0, j0 + step, ... (n of them).  A software pipeline: one
// batch of wgmma issues S_j = Q K_j^T and O += P_i V_i of the previous tile
// i; the softmax of S_j runs while that P V completes; then O is rescaled
// and P_j split.  The two consumers take turns issuing their batch
// (ping-pong on named barriers 1 and 2), so one's softmax overlaps the
// other's wgmma.  A consumer with n tiles takes n + 1 turns (the last is
// its final P V); consumer 0 goes first, given its first turn by
// consumer 1, and each gives the other the turn after its own while the
// other has one left (``other_turns``, -1 for no turns at all).  Returns
// (m, l, acc) in its registers; ``wt`` is the thread's index in the
// warpgroup.
template <int D>
__device__ __forceinline__ void ws_consume(
    SmemWs<D>& sm, float (&acc)[Ws<D>::NC * 32], float (&m)[2], float (&l)[2],
    int Sk, int causal, float scale, int cw, int wt, int row0, int j0,
    int step, int n, int other_turns) {
  using W = Ws<D>;
  constexpr int NC = W::NC;
  constexpr int BK = W::BK;
  const int warp = wt >> 5;
  const int lane = wt & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8
  const int c_lo = 2 * (lane & 3);           // + 8j + {0, 1}: columns
  const int mine = BAR_TURN + cw;
  const int other = BAR_TURN + 1 - cw;
  const __nv_bfloat16* qw = sm.q[0] + (W::SPLIT ? 0 : cw * 64 * DC);

  uint32_t a_hi[W::NP], a_lo[W::NP];
  float sc[W::NS];
#pragma unroll
  for (int i = 0; i < W::NS; ++i) sc[i] = 0.f;
  // turns after which this consumer gives one: consumer 0 gives after its
  // k-th if consumer 1 has a k-th, consumer 1 if consumer 0 has a (k+1)-th
  const int gives = cw == 0 ? other_turns : other_turns - 1;
  int turn = 0;  // turns taken
  for (int t = 0; t < n; ++t) {
    const int j = j0 + t * step;
    const int s = j % W::STAGES;
    const int jp = j - step;                   // the previous tile
    const int sp = jp % W::STAGES;

    if (other_turns >= 0) turn_wait(mine);
    ws_wait_warp(&sm.bar_k[s], (j / W::STAGES) & 1);
    if (t > 0) ws_wait_warp(&sm.bar_v[sp], (jp / W::STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = sw128_desc(qw + (kk / 4) * W::BQ * DC +
                                     (kk % 4) * 16);
      const uint64_t db = sw128_desc(sm.k[s][kk / 4] + (kk % 4) * 16);
      if constexpr (BK == 128)
        wgmma_ss_n128(sc, da, db, kk > 0);
      else
        wgmma_ss(sc, da, db, kk > 0);
    }
    wg_commit();
    if (t > 0) issue_pv<NC, BK>(acc, a_hi, a_lo, sm.v[sp]);
    wg_commit();
    if (turn++ < gives) turn_give(other);
    wgmma_wait<1>();  // S of tile j is in (P V of tile jp may run on)
    pin(sc);
    if (wt == 0) mbar_arrive(&sm.bar_k_free[s]);

    float alpha[2];
    const bool grow = ws_softmax<W::NS>(sc, m, l, alpha, j * BK, BK, row0,
                                        r_lo, c_lo, Sk, causal, scale);

    wgmma_wait<0>();  // P V of tile jp is done: its V and P are free
    pin(acc);
    pin(a_hi);
    pin(a_lo);
    if (t > 0 && wt == 0) mbar_arrive(&sm.bar_v_free[sp]);
    ws_rescale_split<NC, W::NS>(acc, alpha, grow, sc, a_hi, a_lo);
  }
  if (n > 0) {  // the last turn: P V of the last tile
    const int j = j0 + (n - 1) * step;
    const int s = j % W::STAGES;
    if (other_turns >= 0) turn_wait(mine);
    ws_wait_warp(&sm.bar_v[s], (j / W::STAGES) & 1);
    wg_fence();
    issue_pv<NC, BK>(acc, a_hi, a_lo, sm.v[s]);
    wg_commit();
    if (turn++ < gives) turn_give(other);
    wgmma_wait<0>();
    pin(acc);
    if (wt == 0) mbar_arrive(&sm.bar_v_free[s]);
  }
}

template <int D>
__global__ void __launch_bounds__(WS_NT, 1)
flash_prefill_ws_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                        int groups, int causal, int swap_q, int swap_k,
                        int swap_v, long long o_sbh, long long o_ss,
                        float scale) {
  using W = Ws<D>;
  constexpr int NC = W::NC;
  constexpr int BK = W::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  SmemWs<D>& sm = *reinterpret_cast<SmemWs<D>*>(smem_raw + pad);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * W::BQ;  // longest first
  const int kvh = bh / groups;
  const int t = threadIdx.x;
  const int q_last = min(q0 + W::BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  if (t == 0) {
    mbar_init(&sm.bar_q, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&sm.bar_k[s], 1);
      mbar_init(&sm.bar_v[s], 1);
      mbar_init(&sm.bar_k_free[s], W::SPLIT ? 1 : 2);
      mbar_init(&sm.bar_v_free[s], W::SPLIT ? 1 : 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, broadcast from lane 0 so that the compiler sees a
  // warp-uniform branch (and gives each side its own register budget)
  const int wg = __shfl_sync(0xffffffffu, t >> 7, 0);

  if (wg == 0) {
    // -- producer: one thread keeps the ring full ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      // a 64-row box wholly past the tensor is requested at row 0 instead
      // (its rows are masked or never stored); a box that overlaps the end
      // is zero-filled by TMA
      mbar_expect_tx(&sm.bar_q, W::Q_BYTES);
      for (int h = 0; h < W::BQ; h += 64) {
        const Coord cq = coord(q0 + h < Sq ? q0 + h : 0, bh, swap_q);
        for (int c = 0; c < NC; ++c)
          tma_load(sm.q[c] + h * DC, &mq, &sm.bar_q, DC * c, cq.c1, cq.c2);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % W::STAGES;
        const uint32_t freed = ((j / W::STAGES) - 1) & 1;
        if (j >= W::STAGES)  // K of tile j - STAGES is done with
          ws_wait(&sm.bar_k_free[s], freed);
        mbar_expect_tx(&sm.bar_k[s], W::KV_BYTES);
        for (int r = 0; r < BK; r += 64) {
          const Coord ck = coord(j * BK + r < Sk ? j * BK + r : 0, kvh,
                                 swap_k);
          for (int c = 0; c < NC; ++c)
            tma_load(sm.k[s][c] + r * DC, &mk, &sm.bar_k[s], DC * c, ck.c1,
                     ck.c2);
        }
        if (j >= W::STAGES)  // ... and its V
          ws_wait(&sm.bar_v_free[s], freed);
        mbar_expect_tx(&sm.bar_v[s], W::KV_BYTES);
        for (int r = 0; r < BK; r += 64) {
          const Coord cv = coord(j * BK + r < Sk ? j * BK + r : 0, kvh,
                                 swap_v);
          for (int c = 0; c < NC; ++c)
            tma_load(sm.v[s][c] + r * DC, &mv, &sm.bar_v[s], DC * c, cv.c1,
                     cv.c2);
        }
      }
    }
  } else {
    // -- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int wt = t & 127;
    const int warp = wt >> 5;
    const int lane = wt & 31;
    const int r_lo = warp * 16 + (lane >> 2);
    const int c_lo = 2 * (lane & 3);
    float acc[NC * 32];
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    ws_wait_warp(&sm.bar_q, 0);
    // tiles and turns of each consumer; consumer 0 takes the first turn,
    // given by consumer 1 (no turns at all when one consumer has no tile)
    int row0, j0, step, n, n_other;
    if constexpr (W::SPLIT) {
      row0 = q0;
      j0 = cw;
      step = 2;
      n = (n_kt + 1 - cw) / 2;
      n_other = (n_kt + cw) / 2;
    } else {
      row0 = q0 + 64 * cw;
      j0 = 0;
      step = 1;
      n = n_other = n_kt;
    }
    const int other_turns = n > 0 && n_other > 0 ? n_other + 1 : -1;
    if (cw == 1 && other_turns >= 0) turn_give(BAR_TURN);
    ws_consume<D>(sm, acc, m, l, Sk, causal, scale, cw, wt, row0, j0, step,
                  n, other_turns);

    if constexpr (W::SPLIT) {
      // consumer 1 hands (m, l, acc) to consumer 0 through the K ring, in
      // its own fragment order, once both are done with every tile
      float* x = reinterpret_cast<float*>(&sm.k[0][0][0]);
      asm volatile("bar.sync %0, 256;\n" :: "r"(BAR_MERGE) : "memory");
      if (cw == 1) {
#pragma unroll
        for (int i = 0; i < NC * 32; ++i) x[i * 128 + wt] = acc[i];
        x[NC * 32 * 128 + 2 * wt] = m[0];
        x[NC * 32 * 128 + 2 * wt + 1] = m[1];
        x[NC * 32 * 128 + 256 + 2 * wt] = l[0];
        x[NC * 32 * 128 + 256 + 2 * wt + 1] = l[1];
      }
      asm volatile("bar.sync %0, 256;\n" :: "r"(BAR_MERGE) : "memory");
      if (cw == 1) return;
      float e0[2], e1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = x[NC * 32 * 128 + 2 * wt + h];
        const float l1 = x[NC * 32 * 128 + 256 + 2 * wt + h];
        const float mm = fmaxf(m[h], m1);
        e0[h] = ex2(m[h] - mm);
        e1[h] = ex2(m1 - mm);
        l[h] = l[h] * e0[h] + l1 * e1[h];
      }
#pragma unroll
      for (int i = 0; i < NC * 32; ++i) {
        const int h = (i >> 1) & 1;
        acc[i] = acc[i] * e0[h] + x[i * 128 + wt] * e1[h];
      }
    }

    // -- epilogue: acc / max(l, 1e-30) in bf16, ragged Sq masked -----------
    const int rq = row0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rq + r_lo + 8 * h;
      if (row >= Sq) continue;
      const float lc = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* op =
          o + bh * o_sbh + static_cast<long long>(row) * o_ss;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = 4 * c + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(op + DC * cc + 8 * c + c_lo) =
              __floats2bfloat162_rn(acc[32 * cc + i] / lc,
                                    acc[32 * cc + i + 1] / lc);
        }
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

// Head dim 64 runs the one-warpgroup kernel (64-row query tiles), 128 and
// 256 the warp-specialised one (128-row query tiles).
template <int D, bool WS>
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
  constexpr int bq = WS ? Ws<D>::BQ : BQ;
  const int n_qt = (Sq + bq - 1) / bq;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, n_qt);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  if constexpr (WS) {
    const int smem = static_cast<int>(sizeof(SmemWs<D>)) + 1024;
    const cudaError_t err = allow_smem<flash_prefill_ws_kernel<D>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_prefill_ws_kernel<D><<<grid, WS_NT, smem, stream>>>(
        mq, mk, mv, out, Sq, Sk, groups, causal, swap_q, swap_k, swap_v,
        o_sbh, o_ss, scale);
  } else {
    const int smem = static_cast<int>(sizeof(Smem<D>)) + 1024;  // + align
    const cudaError_t err = allow_smem<flash_prefill_sm90_kernel<D>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_prefill_sm90_kernel<D><<<grid, NT, smem, stream>>>(
        mq, mk, mv, out, Sq, Sk, groups, causal, swap_q, swap_k, swap_v,
        o_sbh, o_ss, scale);
  }
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
#define REPRO_SM90(DD, WS)                                                 \
  launch<DD, WS>(enc, q, k, v, o, BH, Sq, Sk, groups, causal, q_sbh, q_ss, \
                 k_sbh, k_ss, v_sbh, v_ss, o_sbh, o_ss, scale, st)
  if (D == 64) return REPRO_SM90(64, false);
  if (D == 128) return REPRO_SM90(128, true);
  if (D == 256) return REPRO_SM90(256, true);
#undef REPRO_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}
