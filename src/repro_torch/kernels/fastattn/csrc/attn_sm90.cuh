// The bf16 attention-forward mainloop shared by fastattn_fwd.cu and
// paged_prefill.cu on Hopper (sm_90a): S = Q K^T and O += P V on the
// tensor cores with `wgmma`, K/V staged through a three-slot shared-memory
// ring filled by `cp.async` and tracked by mbarriers.
//
// One CTA owns BQ query rows of one (query head, sequence); each consumer
// warpgroup (4 warps) owns 64 of them: two warpgroups (BQ = 128) for
// head_dim <= 128, one (BQ = 64) for head_dim 256, whose 64 x 256 f32
// accumulator alone is 128 registers a thread.
//
//  * Shared memory.  Every tile is stored K-major in 128-byte rows with the
//    128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), in
//    DP = ceil(D / 64) * 64 columns split into 64-column blocks: Q
//    [DP/64][BQ][64] once per CTA, in bf16 as it is; each stage K and V
//    [DP/64][kv1][64].  A head_dim that is no multiple of 64 (80, 96)
//    fills its last block only in part: the copies zero-fill the columns
//    at and past D, so no padded column ever holds garbage.  The tiles
//    start on 1024-byte boundaries (the swizzle atom).
//  * S = Q K^T: `wgmma m64n64k16`, both operands read from shared memory
//    through descriptors (K-major, 128-byte swizzle), 16 columns of D a
//    step (D / 16 steps: the padded columns are never multiplied), 64
//    keys wide (level 2).  Scale, softcap and mask run on the f32
//    accumulator fragment: thread t of warp w holds rows 16w + t/4 and
//    16w + t/4 + 8 and columns 8j + 2(t%4) + {0, 1}, so a row's max is
//    reduced over the 4 lanes that share it (xor 1, 2) and its sum once at
//    the end.  exp(x - m) is computed as ex2(x * sl - m * sl), one FFMA
//    and one SFU op, with sl = scale * log2(e) folded in.
//  * O += P V: `wgmma m64nDPk16` with P from registers (the S fragment's
//    pairs are the A fragment's, rounded to bf16 as the JAX kernel rounds
//    P to V's dtype) and V from shared memory as stored, keys as rows and
//    D contiguous: MN-major for this product, read with the descriptor's
//    transpose bit (LBO = the stride of a 64-column block, SBO = 8 keys).
//    Head dims 80 and 96 take the n128 product over V's zero-filled
//    columns (the MN-major 128-byte-swizzled layout reads N in whole
//    64-column atoms, so n80 / n96 would need another V layout): the
//    accumulator's columns past D stay exactly 0 and are not stored.
//  * Ordering (within a warpgroup): sub-tile j's S and sub-tile j-1's P V
//    are issued together (wgmma.fence, two commit groups); wait 1 retires
//    S, whose softmax then runs while the P V is still on the tensor cores;
//    wait 0 retires the P V, and only then is O rescaled by alpha and P
//    replaced.  Register fences keep the compiler from touching the
//    accumulators or P between issue and wait.  The wgmma sequence has no
//    branch around it (ptxas serializes wgmmas it finds on a divergent
//    path): the first sub-tile issues a P V of P = 0.
//  * Ping-pong (two warpgroups): the warpgroups issue their wgmmas in
//    turns, handed over through two named barriers, so that one's softmax
//    runs while the other's products do.  Both walk the CTA's sub-tiles; a
//    warpgroup that SKIPs one passes its turn on.
//  * Ring: three slots; stage t + 1 is loaded while stage t is computed,
//    and the third slot holds stage t - 1, whose last P V may still be
//    pending.  Every thread issues its share of a stage's copies and one
//    `cp.async.mbarrier.arrive.noinc` on the slot's "full" mbarrier; a
//    warpgroup waits on it (then fence.proxy.async) before its wgmmas read
//    the slot, and arrives on the slot's "empty" mbarrier once none of its
//    wgmmas reads it any more, which the loader of the slot's next stage
//    waits for.  No __syncthreads in the loop: the warpgroups drift apart
//    by up to a stage.  A row's address comes from the caller (dense:
//    key * D; paged: through the page table), so a stage may straddle
//    pages of any size.  Keys at or past kv_valid are zero-filled (the
//    src-size-0 form of cp.async), never read.
//  * Two levels (the paper's §4.1): level 1 is the stage of kv1 keys, one
//    barrier each, walked only over [first_key, last_key]; level 2 is the
//    64-key wgmma sub-tile, classified for each warpgroup's 64 rows by the
//    rule of tiling_mask.classify_block: SKIP is neither loaded (unless
//    the CTA's other warpgroup needs it) nor multiplied, FULL takes no mask
//    instruction, only PARTIAL is masked, by arithmetic.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKV2 = 64;      // keys per wgmma sub-tile (level 2)
constexpr int STAGES = 3;     // K/V stages in the ring
constexpr int ALIGN = 1024;   // the 128-byte swizzle's atom: 8 rows x 128 B
constexpr int MAX_SMEM = 232448;   // 227 KB: the most one CTA may use
constexpr int TURN = 1;       // named barriers TURN, TURN + 1 (0: syncthreads)

template <int D>
struct Cfg {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256,
                "head_dim must be a multiple of 16 (one k16 step), <= 256");
  static constexpr int DP = (D + 63) / 64 * 64;  // columns a row in SMEM
  static constexpr int NWG = DP <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BQ = 64 * NWG;            // query rows per CTA
  static constexpr int NT = 128 * NWG;           // threads per CTA
  static constexpr int CH = DP / 8;              // 16-byte chunks a row
  static constexpr int CHD = D / 8;              // of them holding data
};

// Dynamic shared memory of one CTA for kv1 keys a stage (alignment slack,
// Q, the ring, its full and empty mbarriers), rows DP columns wide;
// core/tiling.py:smem_working_set computes the same number.
template <int D>
constexpr size_t smem_bytes(int kv1) {
  constexpr int DP = Cfg<D>::DP;
  return (size_t)ALIGN + (size_t)Cfg<D>::BQ * DP * 2 +
         (size_t)STAGES * 2 * kv1 * DP * 2 + (size_t)STAGES * 2 * 8;
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// named barrier `id` over `n` threads: wait for it, or only arrive on it
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- mbarriers: one "full" and one "empty" barrier per ring slot ----------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far is done
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes (cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across the async
// window of a wgmma that reads or writes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// matrix descriptor of a 128-byte-swizzled tile at shared address `addr`
// (byte offsets lbo and sbo)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk c (of DP/8) of row r in a [DP/64][rows][64]
// swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// 2^x on the SFU, denormals flushed: 2^(-1e30) is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in SMEM
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (bf16 pairs), B in
// SMEM, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (bf16 pairs), B in
// SMEM, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// d[64 x 256] += A[64 x 16] B[16 x 256]: A in registers (bf16 pairs), B in
// SMEM, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(o, a, db);
}

// ---- the mainloop ----------------------------------------------------------
//
// One CTA: rows [0, q_rows) of the BQ-row block at `qh` (row-major, D
// contiguous, rows D apart), global position of row 0 `q_start`, against
// the keys whose rows lie at kbase/vbase + row_off(key); writes the rows
// that exist, D columns each, to `oh`.  Masks: key < kv_valid, causal
// (q_start + row >= key), window (q_start + row - key < window); softcap
// after the scale.  A row with no visible key is exactly 0.  kv1: keys a
// stage, a multiple of 64; dynamic shared memory smem_bytes<D>(kv1).
template <int D, class RowOff>
__device__ __forceinline__ void attn_fwd_tile(
    const bf16* __restrict__ qh, int q_rows, const bf16* __restrict__ kbase,
    const bf16* __restrict__ vbase, RowOff row_off, bf16* __restrict__ oh,
    int q_start, int kv_valid, int causal, int window, float softcap,
    float scale, int kv1) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) uint8_t attn_smem[];
  const uint32_t sQ = (smem_u32(attn_smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t sRing = sQ + C::BQ * C::DP * 2;
  const uint32_t op_bytes = (uint32_t)kv1 * C::DP * 2;   // K or V a stage
  const int tid = threadIdx.x;
  // the warpgroup index read from lane 0 is warp-uniform to the compiler,
  // so the branches around the wgmmas are not divergent paths to it
  // (otherwise ptxas serializes every wgmma, C7520)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  // keys the CTA can see, and the rows of this warpgroup
  const int q_end = q_start + C::BQ - 1;
  const int last_key = min(causal ? q_end : INT_MAX, kv_valid - 1);
  const int first_key = window > 0 ? max(0, q_start - window + 1) : 0;
  const int wq_start = q_start + 64 * wg;
  const int wq_end = wq_start + 63;
  // global positions of this thread's two accumulator rows
  const int r0 = wq_start + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  // scores live in the logit domain (after the softcap, if any) and enter
  // exp2 as x * sl: sl folds in the scale and log2(e)
  const float sl = softcap > 0.f ? LOG2E : scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;

  // O: column 8g + 2(t%4) + {0, 1} in o[4g + {0, 1}] (row r0) and
  // o[4g + 2 + {0, 1}] (row r1); past D / 2 the padded columns, always 0
  float o[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};      // this thread's share of the row sums
  uint32_t p[4][4];             // P as the A fragment of 4 k16 steps
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0u;

  // a sub-tile at keys [ks, ks + 63] that no row of [lo, lo + n) can see
  auto skipped = [&](int ks, int lo, int n) {
    return ks >= kv_valid || (causal && ks > lo + n - 1) ||
           (window > 0 && ks + BKV2 - 1 <= lo - window);
  };

  // the live sub-tiles of macro-block mb -> ring slot `slot`
  auto load_stage = [&](int mb, int slot) {
    const uint32_t sK = sRing + (uint32_t)slot * 2 * op_bytes;
    const uint32_t sV = sK + op_bytes;
    constexpr int ROWS = C::NT / C::CH;    // key rows one pass covers
    const int c = tid % C::CH;             // this thread's 16-byte chunk
    const bool data = c < C::CHD;          // false: a padded column, zeros
    for (int s = 0; s < kv1 / BKV2; ++s) {
      const int ks = mb * kv1 + s * BKV2;
      if (skipped(ks, q_start, C::BQ)) continue;
#pragma unroll
      for (int it = 0; it < BKV2 / ROWS; ++it) {
        const int j = tid / C::CH + it * ROWS;
        const int key = ks + j;
        const bool ok = key < kv_valid && data;
        const size_t off = ok ? row_off(key) + (size_t)c * 8 : 0;
        const uint32_t dst = swz(s * BKV2 + j, c, kv1);
        cp_async16(sK + dst, kbase + off, ok);
        cp_async16(sV + dst, vbase + off, ok);
      }
    }
  };

  // a P V whose P is in `p` and whose V sub-tile is at `pv_v`, issued
  // together with the next sub-tile's S so that the softmax of that S
  // overlaps it.  Before the first sub-tile P is 0 and its P V adds
  // nothing: every sub-tile issues one, so the wgmma sequence has no
  // branch (a wgmma or wait under a branch makes ptxas serialize them)
  bool pv_pending = false;
  uint32_t pv_v = 0;
  auto issue_pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<C::DP>(o, p[kk], desc_sw128(pv_v + kk * 16 * 128,
                                           (uint32_t)kv1 * 128, 1024));
    wgmma_commit();
  };

  if (last_key >= first_key) {
    // full[i]: every thread's copies into slot i landed (NT cp.async
    // arrivals); empty[i]: every thread's warpgroup is done reading it
    const uint32_t full0 = sRing + (uint32_t)STAGES * 2 * op_bytes;
    const uint32_t empty0 = full0 + STAGES * 8;
    if (tid == 0) {
      for (int i = 0; i < STAGES; ++i) {
        mbar_init(full0 + 8 * i, C::NT);
        mbar_init(empty0 + 8 * i, C::NT);
      }
    }
    __syncthreads();
    // Q once per CTA, bf16 as it is; rows past the end and padded columns
    // zero-filled
    for (int idx = tid; idx < C::BQ * C::CH; idx += C::NT) {
      const int r = idx / C::CH;
      const int c = idx % C::CH;
      const bool ok = r < q_rows && c < C::CHD;
      cp_async16(sQ + swz(r, c, C::BQ), qh + (ok ? (size_t)r * D + c * 8 : 0),
                 ok);
    }
    const int mb_first = first_key / kv1;
    const int n_stages = last_key / kv1 - mb_first + 1;
    // the last key this warpgroup can see: its live sub-tiles are one run
    const int wg_last_key = min(causal ? wq_end : INT_MAX, kv_valid - 1);
    load_stage(mb_first, 0);
    cp_async_arrive(full0);
    // the two warpgroups issue their wgmmas in turns (named barriers TURN
    // and TURN + 1), so one's softmax runs while the other's products do;
    // warpgroup 0 goes first
    if constexpr (C::NWG == 2)
      if (wg == 1) bar_arrive(TURN, C::NT);

    for (int t = 0; t < n_stages; ++t) {
      const int mb = mb_first + t;
      const int slot = t % STAGES;
      // stage t + 1 -> the slot of stage t + 1 - STAGES, once both
      // warpgroups have released it
      if (t + 1 < n_stages) {
        const int next = (t + 1) % STAGES;
        if (t + 1 >= STAGES)
          mbar_wait(empty0 + 8 * next, ((t + 1 - STAGES) / STAGES) & 1);
        load_stage(mb + 1, next);
        cp_async_arrive(full0 + 8 * next);
      }
      // stage t has landed (every thread's copies), visible to wgmma
      mbar_wait(full0 + 8 * slot, (t / STAGES) & 1);
      fence_proxy_async();

      const uint32_t sK = sRing + (uint32_t)slot * 2 * op_bytes;
      const uint32_t sV = sK + op_bytes;
      for (int s = 0; s < kv1 / BKV2; ++s) {
        const int ks = mb * kv1 + s * BKV2;
        if (skipped(ks, q_start, C::BQ)) continue;   // no row of the CTA
        // level 2 for this warpgroup's 64 rows (warpgroup-uniform)
        const bool live = !skipped(ks, wq_start, 64);
        if (!live) {
          if constexpr (C::NWG == 2) {   // pass the turn on
            bar_sync(TURN + wg, C::NT);
            bar_arrive(TURN + (wg ^ 1), C::NT);
          }
          continue;
        }
        const bool full = ks + BKV2 - 1 < kv_valid &&
                          (!causal || ks + BKV2 - 1 <= wq_start) &&
                          (window <= 0 || ks >= wq_end - window + 1);

        // ---- S = Q K^T, and the previous sub-tile's O += P V -------------
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        if constexpr (C::NWG == 2) bar_sync(TURN + wg, C::NT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t kb = sK + (kk / 4) * (uint32_t)kv1 * 128 +
                              s * BKV2 * 128 + (kk % 4) * 32;
          const uint32_t qa = sQ + (kk / 4) * C::BQ * 128 + wg * 64 * 128 +
                              (kk % 4) * 32;
          wgmma_ss_n64(sc, desc_sw128(qa, 16, 1024),
                       desc_sw128(kb, 16, 1024), 1);
        }
        wgmma_commit();
        if (!pv_pending) pv_v = sV + s * BKV2 * 128;   // P = 0: adds nothing
        issue_pv();
        if constexpr (C::NWG == 2) bar_arrive(TURN + (wg ^ 1), C::NT);
        wgmma_wait<1>();      // S is done; the P V may still run
        fence_regs(sc);

        // ---- softcap, PARTIAL-only mask ---------------------------------
        if (softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = softcap * tanhf(sc[i] * cap_in);
        }
        if (!full) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = (i & 2) ? r1 : r0;
            const int col = ks + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            const bool ok = col < kv_valid && (!causal || row >= col) &&
                            (window <= 0 || row - col < window);
            sc[i] = ok ? sc[i] : NEG_INF;
          }
        }
        // ---- online softmax: rows are shared by 4 lanes ---------------------
        float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
        float msl[2], alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = mt[h];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float mn = fmaxf(m[h], x);
          // a row with no visible key so far keeps p = 0 (not exp(0) = 1)
          const float mref = mn == NEG_INF ? 0.f : mn;
          alpha[h] = ex2((m[h] - mref) * sl);
          msl[h] = mref * sl;
          m[h] = mn;
        }
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = ex2(fmaf(sc[i], sl, -msl[(i >> 1) & 1]));
          ps[(i >> 1) & 1] += sc[i];
        }
        l[0] = l[0] * alpha[0] + ps[0];
        l[1] = l[1] * alpha[1] + ps[1];

        // ---- the previous P V done: rescale O, new P ----------------------
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
          p[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
          p[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
          p[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
        }
        pv_pending = true;
        pv_v = sV + s * BKV2 * 128;
      }
      // the pending P V runs now if no later stage holds a sub-tile of this
      // warpgroup (its V slot is reloaded two stages on)
      if (pv_pending && (t == n_stages - 1 || (mb + 1) * kv1 > wg_last_key)) {
        wgmma_fence();
        issue_pv();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[j][e] = 0u;
        pv_pending = false;
      }
      // no wgmma of this warpgroup reads stage t - 1 any more: its pending
      // P V ran in this stage's first live sub-tile or was flushed
      if (t >= 1) mbar_arrive(empty0 + 8 * ((t - 1) % STAGES));
    }
    // warpgroup 1's last turn hand-back
    if constexpr (C::NWG == 2)
      if (wg == 0) bar_sync(TURN, C::NT);
  }

  // ---- normalise and store the rows that exist --------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = l[h];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const float inv = x > 0.f ? 1.f / x : 0.f;
    const int r = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (r >= q_rows) continue;
    bf16* orow = oh + (size_t)r * D + 2 * (lane % 4);
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g) = __floats2bfloat162_rn(
          o[4 * g + 2 * h] * inv, o[4 * g + 2 * h + 1] * inv);
  }
}

}  // namespace sm90
