// K1, f32 mode, and K5: mean-shift on Hopper's tensor cores in 3xTF32,
// with the key tiles streamed by the bulk-copy engine.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, mean_shift_iterations_pallas
// with f32 dots (pallas_call at :212, kernel body _make_ms_multi_kernel
// :107-182), and mean_shift_step_pallas (pallas_call at :83, kernel body
// _ms_step_kernel :27-57), which is this kernel's one-iteration run with
// queries apart from the keys. K1's bf16 mode is ms_iterations_tc.cu.
//
// Computes, for `iterations` steps with m0 = the queries Q (unit rows,
// D = 128) and the keys X (K1: Q = X):
//   s = m . X^T,  K = exp((2 s - 2) * inv2b2)  (key columns >= nk give 0),
//   new_m = (K @ X) / (rowsum(K) + 1e-12),  m = new_m / (|new_m| + 1e-12),
// at f32 accuracy, and writes the f32 m of the last iteration. K5 masks the
// key columns by the key count nk; the TPU kernel masks them by the query
// count, which agrees at m = x, its only use.
//
// 3xTF32. The tensor cores read a tf32 operand (10 mantissa bits) of an
// f32 word by ignoring its low 13 bits. Each operand a is split as
// a = hi + lo, hi = tf32_round(a) (cvt.rna: low 13 bits zero, so the
// tensor cores read it whole), lo = a - hi (exact in f32, |lo| <= 2^-11
// |a|; the tensor cores truncate it, an error of at most 2^-21 |a|), and a
// product as hi.hi + hi.lo + lo.hi with f32 accumulation: three tensor-core
// products where the bf16 kernel runs one. lo.lo (<= 2^-22 |a b|) is
// dropped. S adds them as (hi.hi + lo.hi) + hi.lo (two accumulators), O
// += P X as one chain.
//
// Bound on this card: operations. One iteration is two N x N x 128
// products, 4 N^2 D FLOP, tripled: 7.7e12 FLOP per 50-iteration call at
// N = 10,000, 15.5 ms at the 495 TFLOP/s of TF32 (the CUDA cores' f32 FMA
// would take 38.2 ms at 67 TFLOP/s for the 2.56e12 FLOP of one product
// each). The 5e9 exponentials per call are a second floor of about 1.3 ms
// on the MUFU units.
//
// Design: ms_iterations_tc.cu's pipeline, in tf32. A block has two consumer
// warpgroups, each owning 64 rows of m for all iterations, and one producer
// warp that keeps a ring of STAGES key tiles in flight with 1-D
// cp.async.bulk copies, completion on mbarriers. The wrapper lays the keys
// out once (kernels.ms_tiles_tf32) in 16-row tiles of 32 KB whose bytes are
// already wgmma's 128-byte-swizzled canonical layout. Per key tile a
// consumer runs
//   S = m . X_t^T  16 x (RS-wgmma m64n32k8: m hi from registers against the
//                  tile's hi and lo rows as one 32-row operand, so hi.hi and
//                  hi.lo in one product; SS-wgmma m64n16k8: m lo from shared
//                  memory against the hi rows, lo.hi), 16 k-steps,
//   P = ex2((s - 1) c), c = 2 inv2b2 log2(e): one FADD folding the n32
//                  product's two halves, one FFMA + one MUFU a score,
//                  the f32 row sums kept per thread, masked in the last tile,
//                  P split into hi and lo tf32 A fragments in registers,
//   O += P . X_t   6 x RS-wgmma m64n128k8 (2 k-steps x 3 products),
// with the next tile's S issued together with this tile's update and its
// exponentials run while the tensor cores do the update (FlashAttention-3's
// in-warpgroup pipeline), and setmaxnreg moving registers from the
// producer to the consumers. The work split over the card (kernels.ms_plan:
// (128-row block, key tile) units cut into one run per SM, partial O and
// row sums of a shared row block added through a workspace in L2 in the
// same order by every sharer, under a cooperative launch) is the bf16
// kernel's.
//
// Shared-memory operand bytes, the limit of this design. A wgmma waits for
// its operands: at the SM's 128 bytes a clock, an SS m64n16k8 (A 2 KB, B
// 0.5 KB) takes 20 clocks for 8 clocks of TF32 work, an SS m64n32k8 24 for
// 16, an RS m64n32k8 (B 1 KB) 8 for 16. Per key tile a consumer reads
// 16 x (1 KB + 2.5 KB) = 56 KB for S and 6 x 4 KB = 24 KB for O, 160 KB a
// block; m hi from shared memory (the exit's form) makes it 224 KB, and
// three SS m64n16k8 a k-step (m hi read twice) 288 KB. The operand probe
// (below; chip_smoke.py phase 6) times each layout's products alone on an
// H100: a tile's S and O take 1,920 clocks an SM with m hi from registers,
// 2,146 from shared memory, 2,646 in three m64n16k8 a k-step, against
// 1,536 of TF32 work (PERF.md §6). m lo stays in shared memory: with it in
// registers too (128 a thread beside O's 64) the consumers would spill.
//
// Where it differs from the bf16 kernel, and why:
// - wgmma reads 32-bit (tf32) operands only K-major: it transposes 16-bit
//   types only. The bf16 kernel reads one X tile K-major for S and
//   MN-major for O += P X; here a key tile holds X twice: rows x features
//   (K = features contiguous) for S, each 32-feature block its 16 rows' hi
//   and then their lo (the n32 product's B), and its transpose, features x
//   rows (K = rows contiguous), for the update, as hi and lo. The
//   transposed half packs the 16 rows' hi and lo into one 128-byte row of
//   32 values, so both halves use the 128-byte swizzle (16-byte chunk j of
//   a 128-byte row r stored at chunk j ^ (r % 8)).
// - P and m hi are A operands from registers. A tf32 A fragment holds
//   columns k and k + 4 of a k-step (rows r, r + 8), while the S
//   accumulator hands a thread columns 2k and 2k + 1. So the wrapper
//   stores the 8 rows of each k-step in the transposed half in the order
//   0, 2, 4, 6, 1, 3, 5, 7: slot k of the k-step holds the key row that the
//   thread's P value at slot k multiplies, and no shuffle is needed. m hi
//   goes through shared memory once a segment instead: store_m writes it in
//   the fragments' thread order and each thread loads its 64 values.
// - Shared memory. An f32 tile is twice a bf16 tile and hi + lo doubles it
//   again: m as hi + lo is 64 KB a consumer (128 KB a block), a 16-row key
//   tile 32 KB, three stages 96 KB: 230,448 bytes of the 232,448 a block
//   can have. A block whose units span two row blocks (the exchange grid)
//   cannot keep both row blocks' m, as the bf16 kernel does: the second
//   row block's new m goes to a workspace in L2 in thread order (each
//   thread reads back what it wrote) and is split into shared memory again
//   before that row block's tiles, once an iteration. The first
//   iteration's m is read from the f32 queries directly.
// - Registers. O is 64 x 128 f32, 64 registers a thread; m hi 64, S of a
//   16-row tile 16, its fold 8, P's hi and lo fragments 16. ptxas's
//   C751x notes ("wgmma serialized") would mean a register of an
//   unfinished wgmma is written, or too few registers for the pipeline: P
//   is split only after the update that reads the previous fragments
//   retired, as in the bf16 kernel, and the exponentials run on the fold,
//   never in the n32 accumulator.
// - Exponentials: ex2.approx.ftz with the FFMA pre-scale, within a few ulp
//   of expf; columns >= nk are exactly 0, as in expf's masked version.
// A wait that never ends traps instead of hanging the card.
//
// K1's early exit (tol > 0; the TPU kernel's early_exit=True variant,
// _make_ms_multi_kernel :165-180, chosen at :213) is ms_exit.cuh's kernel
// (shared with the bf16 kernel) on this source's tile pipeline
// (segment_tiles) and m operand (store_m), with m hi read from shared
// memory (the n32 product's SS form); the delta is taken on the f32 m
// before it is split into hi and lo.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                          // feature width
constexpr int MTILE = 64;                       // rows of a consumer's m
constexpr int CONSUMERS = 2;                    // consumer warpgroups per block
constexpr int ROWS = MTILE * CONSUMERS;         // rows of m per block
constexpr int TILE = 16;                        // key rows per tile
constexpr int STAGES = 3;                       // key tiles in flight
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int REGS_AT_LAUNCH = 168;             // 65,536 / 384, a multiple of 8
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;              // 128 x 40 + 256 x 232 <= 384 x 168
constexpr uint32_t M_HALF = MTILE * D * 4;      // m hi (or lo) of a consumer: 32 KB
constexpr uint32_t M_KBLK = MTILE * 128;        // 32 columns of m's 64 rows
// 32 columns of a tile's rows x features: its 16 rows' hi, then their lo
constexpr uint32_t X_KBLK = 2 * TILE * 128;
constexpr uint32_t X_TRANS = 4 * X_KBLK;        // offset of the transposed half
constexpr uint32_t TILE_BYTES = 2 * X_TRANS;    // 32 KB
constexpr uint32_t M_WG_BYTES = 2 * M_HALF;     // a consumer's m, hi and lo
// a block's partial O and row sums in the workspace, per consumer: 16
// float4 and 2 floats per thread, each array in thread order
constexpr int PART_FLOATS = CONSUMERS * (MTILE * D + 2 * 128);
constexpr int SPILL_FLOATS = CONSUMERS * MTILE * D;  // a block's spilled m
// [m hi, lo of each consumer][key ring][full][empty]
constexpr size_t SMEM_BYTES = 1024 + CONSUMERS * 2 * M_HALF
                            + STAGES * TILE_BYTES + 8 * (2 * STAGES);
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// Spins until `poll` returns true. A wait of more than 4 s (the global
// timer, read every 1024 polls) can only be a fault in the pipeline or the
// exchange: it traps, and the launch fails, instead of hanging the card.
template <typename Poll>
__device__ __forceinline__ void spin(Poll poll) {
    uint64_t t0 = 0;
    for (uint32_t polls = 1;; ++polls) {
        if (poll()) return;
        if ((polls & 1023) == 0) {
            uint64_t now;
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
            if (t0 == 0) t0 = now;
            else if (now - t0 > 4000000000ull) __trap();
        }
    }
}

// Waits for the phase of the given parity of an mbarrier to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    spin([&] {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        return done != 0;
    });
}

// Adds 1 to a counter in global memory, releasing (at GPU scope) the
// writes that a barrier ordered before this thread's.
__device__ __forceinline__ void signal(unsigned* counter) {
    asm volatile("fence.acq_rel.gpu;\n"
                 "red.relaxed.gpu.global.add.u32 [%0], 1;"
                 :: "l"(counter) : "memory");
}

// Waits until a counter in global memory reaches `target`, acquiring.
__device__ __forceinline__ void wait_count(const unsigned* counter,
                                           unsigned target) {
    spin([&] {
        unsigned v;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(v) : "l"(counter) : "memory");
        return v >= target;
    });
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: sbo the byte
// offset between 8-row groups (lbo unused).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d[64 x 16] (+)= A[64 x 8] B[8 x 16], tf32, both from shared memory.
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32, both from shared memory.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// d[64 x 16] += A[64 x 8] B[8 x 16], A from registers (the operand
// probe's PROBE_RS).
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
        "\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The first 8 of an n32 accumulator's registers: its columns 0-15, the
// registers an n16 product of the same rows accumulates into.
__device__ __forceinline__ float (&low_cols(float (&d)[16]))[8] {
    return *reinterpret_cast<float (*)[8]>(&d[0]);
}

// d[64 x 128] += A[64 x 8] B[8 x 128], tf32, A from registers, B from
// shared memory.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// hi = tf32_round(v) (to nearest, ties away from zero), as f32 bits
__device__ __forceinline__ uint32_t tf32_hi(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void wg_barrier(int id) {
    asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

// The two consumer warpgroups (256 threads), named barrier 3.
__device__ __forceinline__ void consumers_barrier() {
    asm volatile("bar.sync 3, %0;" :: "n"(CONSUMERS * 128) : "memory");
}

// Where the score product reads m hi from: registers (the fixed-count
// kernel: an RS-wgmma, which reads no A operand from shared memory), or
// shared memory (the exit, whose consumers cannot hold m hi's 64 more
// registers beside its plan without spilling).
enum MHi { M_HI_REGS, M_HI_SMEM };

// The scores of a tile over D = 128, 16 k-steps of 8 through the four
// 32-column blocks of the swizzled key tile: m hi against the block's 32
// rows (the tile's hi, then its lo) in one m64n32k8, so that s[0..7] (its
// columns 0-15) take hi.hi and s[8..15] (columns 16-31) hi.lo, and m lo
// (shared memory) against the hi rows in one m64n16k8 into s[0..7]
// (lo.hi). m hi comes from `mh` (M_HI_REGS) or from shared memory at m,
// where it is read once for the two products it takes part in.
template <MHi MH>
__device__ __forceinline__ void issue_scores(float (&s)[16],
                                             const uint32_t (&mh)[64],
                                             uint32_t m, uint32_t xs) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const uint32_t om = (k >> 2) * M_KBLK + (k & 3) * 32;
        const uint64_t x = smem_desc(xs + (k >> 2) * X_KBLK + (k & 3) * 32);
        if constexpr (MH == M_HI_REGS)
            mma_rs_n32(s, mh[4 * k], mh[4 * k + 1], mh[4 * k + 2],
                       mh[4 * k + 3], x, k > 0);
        else
            mma_ss_n32(s, smem_desc(m + om), x, k > 0);
        mma_ss_n16(low_cols(s), smem_desc(m + M_HALF + om), x, 1);
    }
}

// S = (hi.hi + lo.hi) + hi.lo into p: s[i] and s[8 + i] hold one key's
// columns. p is apart from s: the exponentials written into the retired
// n32 accumulator made ptxas serialize every wgmma (C7511).
__device__ __forceinline__ void fold_scores(float (&p)[8],
                                            const float (&s)[16]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = s[i] + s[8 + i];
}

// This thread's tf32 A fragments of m hi for the 16 k-steps (a float4
// each, in the thread order store_m<M_HI_REGS> writes), into registers.
__device__ __forceinline__ void load_m_hi(uint32_t (&mh)[64], uint32_t m) {
    const uint32_t mine = m + (threadIdx.x % 128) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k)
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(mh[4 * k]), "=r"(mh[4 * k + 1]),
                       "=r"(mh[4 * k + 2]), "=r"(mh[4 * k + 3])
                     : "r"(mine + k * 128 * 16) : "memory");
}

// O += P . X_t over the tile's 16 rows: 2 k-steps of 8 rows, the
// transposed half read K-major (hi in bytes 0-63 of each 128-byte row, lo
// in 64-127).
__device__ __forceinline__ void issue_update(float (&o)[64],
                                             const uint32_t (&ph)[8],
                                             const uint32_t (&pl)[8],
                                             uint32_t xs) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const uint64_t x_hi = smem_desc(xs + X_TRANS + j * 32);
        const uint64_t x_lo = smem_desc(xs + X_TRANS + 64 + j * 32);
        mma_rs_n128(o, ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                    ph[4 * j + 3], x_hi);
        mma_rs_n128(o, ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                    ph[4 * j + 3], x_lo);
        mma_rs_n128(o, pl[4 * j], pl[4 * j + 1], pl[4 * j + 2],
                    pl[4 * j + 3], x_hi);
    }
}

// P = exp((2 s - 2) inv2b2) = ex2((s - 1) c) of tile t, masked to columns
// < n, into the row sums (f32). s[4 j + e] is row r + 8 (e / 2), column
// 8 j + 2 q + (e % 2) of the tile.
__device__ __forceinline__ void exp_tile(float (&s)[8], float& rs0,
                                         float& rs1, int t, int n, int q,
                                         float c) {
    if (t * TILE + TILE > n) {
        const int col0 = t * TILE + 2 * q;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int col = col0 + 8 * (i >> 2) + (i & 1);
            s[i] = col < n ? ex2(fmaf(s[i], c, -c)) : 0.f;
        }
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = ex2(fmaf(s[i], c, -c));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
}

// P as the hi and lo tf32 A fragments of the update's two k-steps. A
// fragment holds (row r, slot q), (r + 8, q), (r, q + 4), (r + 8, q + 4):
// slot q takes the thread's column 8 j + 2 q, slot q + 4 its column
// 8 j + 2 q + 1 (the wrapper stores the key rows in that slot order).
__device__ __forceinline__ void split_tile(const float (&s)[8],
                                           uint32_t (&ph)[8],
                                           uint32_t (&pl)[8]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const float v[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1],
                            s[4 * j + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            ph[4 * j + e] = tf32_hi(v[e]);
            pl[4 * j + e] = __float_as_uint(v[e] - __uint_as_float(ph[4 * j + e]));
        }
    }
}

// Byte offset of element (row, col) in a consumer's swizzled m (lo, M_HALF
// on; hi here in M_HI_SMEM's layout): four 32-column blocks of 64 rows x
// 128 bytes.
__device__ __forceinline__ uint32_t m_offset(int row, int col) {
    return (col >> 5) * M_KBLK + row * 128
         + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// This thread's values of m (rows r, r + 8; columns 8 j + 2 q, + 1 in
// v[4 j .. 4 j + 3], the accumulator layout) into the consumer's m in
// shared memory as hi and lo, visible to wgmma (the async proxy)
// afterwards. lo, and hi for M_HI_SMEM, in the swizzled K-major layout;
// hi for M_HI_REGS as the A fragments of the 16 k-steps in thread order,
// a float4 a thread a k-step: element (R, C) is slot (R % 16) / 8 +
// 2 ((C % 8) / 4) of k-step C / 8 of the thread of R's quad whose lane % 4
// is C % 4 (load_m_hi).
template <MHi MH = M_HI_SMEM>
__device__ __forceinline__ void store_m(const float (&v)[64], uint32_t m,
                                       int r, int q, int wg) {
    wg_barrier(1 + wg);   // every wgmma of this warpgroup has read the old m
    const uint32_t quad = (threadIdx.x % 128) & ~3u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t off = m_offset(r + 8 * h, col);
            const float a = v[4 * j + 2 * h], b = v[4 * j + 2 * h + 1];
            const uint32_t ha = tf32_hi(a), hb = tf32_hi(b);
            if constexpr (MH == M_HI_SMEM) {
                asm volatile("st.shared.v2.b32 [%0], {%1, %2};"
                             :: "r"(m + off), "r"(ha), "r"(hb) : "memory");
            } else {
                // column col + h of rows r and r + 8: slots 2 (q / 2) and
                // 2 (q / 2) + 1 of its thread's fragment
                const uint32_t t = quad | ((2 * q + h) & 3);
                asm volatile("st.shared.v2.b32 [%0], {%1, %2};"
                             :: "r"(m + (j * 128 + t) * 16 + (q >> 1) * 8),
                                "r"(tf32_hi(v[4 * j + h])),
                                "r"(tf32_hi(v[4 * j + 2 + h])) : "memory");
            }
            asm volatile("st.shared.v2.b32 [%0], {%1, %2};"
                         :: "r"(m + M_HALF + off),
                            "r"(__float_as_uint(a - __uint_as_float(ha))),
                            "r"(__float_as_uint(b - __uint_as_float(hb)))
                         : "memory");
        }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_barrier(1 + wg);
}

// The work of an iteration is n_blocks x n_tiles units (a 128-row block of
// m against a 16-row key tile), in row-block-major order; block g of the
// grid takes units [start(g), start(g + 1)), start(g) = floor(g U / grid).
__device__ __forceinline__ long long unit_start(int g, long long units,
                                                int grid) {
    return (long long)g * units / grid;
}

// The grid block whose units include unit u: the largest g with
// start(g) <= u.
__device__ __forceinline__ int unit_owner(long long u, long long units,
                                          int grid) {
    return (int)(((u + 1) * grid - 1) / units);
}

// One row block's share of this grid block's units: key tiles [t0, t1) of
// row block b; this block is contributor `slot` of the `contrib` that
// share the row block.
struct Segment {
    int b, t0, t1, slot, contrib;
};

__device__ __forceinline__ Segment segment(int b, int t0, int t1, int g,
                                           long long units, int grid,
                                           int n_tiles) {
    const int first = unit_owner((long long)b * n_tiles, units, grid);
    const int last = unit_owner((long long)b * n_tiles + n_tiles - 1, units,
                                grid);
    return Segment{b, t0, t1, g - first, last - first + 1};
}

// Where finish_rows puts the new m.
enum Dest { TO_SMEM, TO_SPILL, TO_OUT, NOWHERE };

// new_m = O / (rowsum + 1e-12), m = new_m / (|new_m| + 1e-12) for this
// thread's rows r, r + 8 of the warpgroup's 64; `o` and the row sums hold
// whole sums over the keys, the row sums not yet over the quad. Then m
// goes to the consumer's shared-memory m, to the spill workspace (thread
// order), or, after the last iteration, to `out` (rows < nq).
__device__ __forceinline__ void normalize_rows(float (&o)[64], float rs0,
                                               float rs1) {
    const float den0 = quad_sum(rs0) + 1e-12f;
    const float den1 = quad_sum(rs1) + 1e-12f;
    float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        o[4 * j] /= den0; o[4 * j + 1] /= den0;
        o[4 * j + 2] /= den1; o[4 * j + 3] /= den1;
        ss0 = fmaf(o[4 * j], o[4 * j], ss0);
        ss0 = fmaf(o[4 * j + 1], o[4 * j + 1], ss0);
        ss1 = fmaf(o[4 * j + 2], o[4 * j + 2], ss1);
        ss1 = fmaf(o[4 * j + 3], o[4 * j + 3], ss1);
    }
    const float nrm0 = sqrtf(quad_sum(ss0)) + 1e-12f;
    const float nrm1 = sqrtf(quad_sum(ss1)) + 1e-12f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        o[4 * j] /= nrm0; o[4 * j + 1] /= nrm0;
        o[4 * j + 2] /= nrm1; o[4 * j + 3] /= nrm1;
    }
}

__device__ __forceinline__ void store_rows(const float (&o)[64], Dest dest,
                                           uint32_t m_smem, float* spill,
                                           float* __restrict__ out,
                                           int row0, int nq, int r, int q,
                                           int wg, int tid) {
    if (dest == TO_SMEM) {
        store_m<M_HI_REGS>(o, m_smem, r, q, wg);
    } else if (dest == TO_SPILL) {
        float* sp = spill + wg * MTILE * D + tid * 4;
#pragma unroll
        for (int i = 0; i < 16; ++i)
            __stcg(reinterpret_cast<float4*>(sp + i * 512),
                   make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2],
                               o[4 * i + 3]));
    } else if (dest == TO_OUT) {
        const int g0 = row0 + r, g1 = g0 + 8;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * q;
            if (g0 < nq)
                *reinterpret_cast<float2*>(out + (size_t)g0 * D + col) =
                    make_float2(o[4 * j], o[4 * j + 1]);
            if (g1 < nq)
                *reinterpret_cast<float2*>(out + (size_t)g1 * D + col) =
                    make_float2(o[4 * j + 2], o[4 * j + 3]);
        }
    }
}

__device__ __forceinline__ void finish_rows(float (&o)[64], float rs0,
                                            float rs1, Dest dest,
                                            uint32_t m_smem, float* spill,
                                            float* __restrict__ out,
                                            int row0, int nq, int r, int q,
                                            int wg, int tid) {
    normalize_rows(o, rs0, rs1);
    store_rows(o, dest, m_smem, spill, out, row0, nq, r, q, wg, tid);
}

// The early exit's chains: its tensor cores add at most this many key
// tiles into the accumulator (a chain: the tiles of one aligned group of
// EXIT_CHAIN in the row block) before the chain is added, in f32, into the
// segment's sums in L2. The accumulator's error grows with the length of
// its chain, so unbounded chains would tie m to the work split, which the
// exit changes as row blocks leave (chip_smoke.py phase 3 prints the
// fixed-count kernel's spread over splits beside the exit's); bounded and
// aligned, they leave the split only the order of the f32 additions.
// Shorter chains cost more additions; longer ones let the split move m by
// more (PERF.md §6).
constexpr int EXIT_CHAIN = 32;

// This thread's accumulator into the segment's sums at `sums` (16 float4,
// the partial's thread order): stored if `first`, else added at L2 (one
// thread per address, in program order).
__device__ __forceinline__ void add_chain(const float (&o)[64], float* sums,
                                          bool first) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        float* p = sums + i * 512;
        if (first)
            asm volatile("st.relaxed.gpu.global.v4.f32 [%0], {%1, %2, %3, %4};"
                         :: "l"(p), "f"(o[4 * i]), "f"(o[4 * i + 1]),
                            "f"(o[4 * i + 2]), "f"(o[4 * i + 3]) : "memory");
        else
            asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], "
                         "{%1, %2, %3, %4};"
                         :: "l"(p), "f"(o[4 * i]), "f"(o[4 * i + 1]),
                            "f"(o[4 * i + 2]), "f"(o[4 * i + 3]) : "memory");
    }
}

// The segment's sums back from `sums` (after this thread's own additions).
__device__ __forceinline__ void load_sums(float (&o)[64], const float* sums) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
        asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(o[4 * i]), "=f"(o[4 * i + 1]), "=f"(o[4 * i + 2]),
                       "=f"(o[4 * i + 3])
                     : "l"(sums + i * 512) : "memory");
}

// The key tiles [t0, t1) of one row block against the warpgroup's m at
// my_m: o = P X and the row sums (not yet over the quad) from zero, each
// tile's ring slot given back to the producer. A software pipeline: the
// scores of the next tile are issued with the update of this one, and
// their exponentials run while the tensor cores do the update; they are
// split into the next A fragments only after the update retired. MH: m hi
// from registers, loaded once (store_m<M_HI_REGS>'s layout), or from
// shared memory. CHAINS (the early exit): o is added into `sums` and
// zeroed after the last tile of each aligned group of EXIT_CHAIN, and at
// the end, where it is loaded back: o holds the sums on return. (A loop
// over chains around the pipeline instead spills: ptxas, 220 bytes.)
template <bool CHAINS, MHi MH>
__device__ __forceinline__ void segment_tiles(float (&o)[64], float& rs0,
                                              float& rs1, uint32_t my_m,
                                              uint32_t x_smem,
                                              uint32_t full_bar,
                                              uint32_t empty_bar, int& stage,
                                              uint32_t& phase, int t0, int t1,
                                              int nk, int q, float c,
                                              int lane,
                                              float* sums = nullptr) {
    // the same in every lane: the operands' descriptors stay on the
    // uniform datapath
    my_m = __shfl_sync(0xffffffffu, my_m, 0);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    rs0 = 0.f;   // row sums of rows r, r + 8
    rs1 = 0.f;
    bool fresh = true;   // CHAINS: no chain has reached `sums` yet
    float s[16], p[8];
    uint32_t ph[8], pl[8], mh[64];
    if constexpr (MH == M_HI_REGS) {
        load_m_hi(mh, my_m);
        reg_fence(mh);
    }
    mbar_wait(full_bar + 8 * stage, phase);
    wg_fence();
    issue_scores<MH>(s, mh, my_m, x_smem + stage * TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    fold_scores(p, s);
    exp_tile(p, rs0, rs1, t0, nk, q, c);
    split_tile(p, ph, pl);
    for (int t = t0; t + 1 < t1; ++t) {
        const int cur = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
        mbar_wait(full_bar + 8 * stage, phase);
        reg_fence(ph);
        reg_fence(pl);
        reg_fence(o);
        wg_fence();   // every register write lands before wgmma
        issue_scores<MH>(s, mh, my_m, x_smem + stage * TILE_BYTES);
        wg_commit();
        issue_update(o, ph, pl, x_smem + cur * TILE_BYTES);
        wg_commit();
        wg_wait<1>();   // the scores; the update may still run
        reg_fence(s);
        fold_scores(p, s);
        exp_tile(p, rs0, rs1, t + 1, nk, q, c);
        wg_wait<0>();
        reg_fence(o);
        reg_fence(ph);
        reg_fence(pl);
        if (lane == 0) mbar_arrive(empty_bar + 8 * cur);
        if constexpr (CHAINS) {
            if ((t + 1) % EXIT_CHAIN == 0) {   // tile t ends its chain
                add_chain(o, sums, fresh);
#pragma unroll
                for (int i = 0; i < 64; ++i) o[i] = 0.f;
                fresh = false;
            }
        }
        split_tile(p, ph, pl);
    }
    reg_fence(ph);
    reg_fence(pl);
    reg_fence(o);
    wg_fence();
    issue_update(o, ph, pl, x_smem + stage * TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
    if constexpr (CHAINS) {
        add_chain(o, sums, fresh);
        load_sums(o, sums);
    }
}

// The exit's cap on a block's run, in key tiles
// (kernels.MS_TF32_EXIT_MIN_RUN)
constexpr int EXIT_MIN_RUN = 16;

// The exit's tiles [t0, t1) of one segment, in chains (`sums`: this
// thread's floats of the segment's partial, where the chains add up); o
// holds the segment's sums on return.
__device__ __forceinline__ void exit_tiles(float (&o)[64], float& rs0,
                                           float& rs1, uint32_t my_m,
                                           uint32_t x_smem, uint32_t full_bar,
                                           uint32_t empty_bar, int& stage,
                                           uint32_t& phase, int t0, int t1,
                                           int n, int q, float c, int lane,
                                           float* sums) {
    segment_tiles<true, M_HI_SMEM>(o, rs0, rs1, my_m, x_smem, full_bar,
                                   empty_bar, stage, phase, t0, t1, n, q, c,
                                   lane, sums);
}

#include "ms_exit.cuh"

__global__ void __launch_bounds__(THREADS, 1)
ms_tf32_kernel(const float* __restrict__ qrows, const uint8_t* __restrict__ xt,
               float* __restrict__ out, const float* __restrict__ inv2b2_ptr,
               float* __restrict__ ws, unsigned* __restrict__ counters,
               int nq, int nk, int n_tiles, int n_blocks, int iterations,
               int slots) {
    extern __shared__ uint8_t smem_raw[];
    // tiles 1024-byte aligned, as the 128-byte swizzle requires
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t m_smem = base;
    const uint32_t x_smem = base + CONSUMERS * 2 * M_HALF;
    const uint32_t full_bar = x_smem + STAGES * TILE_BYTES;
    const uint32_t empty_bar = full_bar + 8 * STAGES;
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;

    // this block's units: one or two segments (the grid has at least as
    // many blocks as row blocks, so a block's units span at most two)
    const int grid = gridDim.x, g = blockIdx.x;
    const long long units = (long long)n_blocks * n_tiles;
    const long long u0 = unit_start(g, units, grid);
    const long long u1 = unit_start(g + 1, units, grid);
    const int b0 = (int)(u0 / n_tiles);
    const long long end0 = (long long)(b0 + 1) * n_tiles;
    const Segment seg0 = segment(
        b0, (int)(u0 - (long long)b0 * n_tiles),
        (int)((u1 < end0 ? u1 : end0) - (long long)b0 * n_tiles), g, units,
        grid, n_tiles);
    const int nseg = u1 > end0 ? 2 : 1;
    const Segment seg1 = segment(b0 + 1, 0, (int)(u1 - end0), g, units, grid,
                                 n_tiles);
    if (seg0.contrib > slots || (nseg == 2 && seg1.contrib > slots))
        __trap();   // the workspace has no room for this split

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_bar + 8 * s, 1);
            mbar_init(empty_bar + 8 * s, CONSUMERS * 4);  // one per warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        // ---- producer: one thread streams the segments' key tiles, every
        // iteration
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        if (tid == 0) {
            int stage = 0;
            uint32_t phase = 0;
            for (int it = 0; it < iterations; ++it) {
                for (int k = 0; k < nseg; ++k) {
                    const Segment sg = k ? seg1 : seg0;
                    for (int t = sg.t0; t < sg.t1; ++t) {
                        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
                        mbar_expect_tx(full_bar + 8 * stage, TILE_BYTES);
                        bulk_load(x_smem + stage * TILE_BYTES,
                                  xt + (size_t)t * TILE_BYTES, TILE_BYTES,
                                  full_bar + 8 * stage);
                        if (++stage == STAGES) { stage = 0; phase ^= 1; }
                    }
                }
            }
        }
    } else {
        // ---- consumer warpgroup `wg`: rows 64 wg .. 64 wg + 63 of each
        // segment's row block
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                     :: "n"(CONSUMER_REGS));
        const int warp = tid / 32, lane = tid % 32;
        const int r = warp * 16 + lane / 4;   // this thread's rows r, r + 8
        const int q = lane % 4;               // its column pairs 8 j + 2 q
        const float c = 2.f * (*inv2b2_ptr) * 1.4426950408889634f;
        const uint32_t my_m = m_smem + wg * 2 * M_HALF;
        // this thread's floats in a workspace partial
        const int part_o = wg * (MTILE * D + 2 * 128) + tid * 4;
        const int part_rs = wg * (MTILE * D + 2 * 128) + MTILE * D + tid;
        // the spilled m of the second segment's row block (exchange grids)
        float* spill = ws + (size_t)2 * n_blocks * slots * PART_FLOATS
                          + (size_t)g * SPILL_FLOATS;

        int stage = 0;
        uint32_t phase = 0;
        for (int it = 0; it < iterations; ++it) {
            const bool last = it == iterations - 1;
            float* ws_it = ws + (size_t)(it & 1) * n_blocks * slots
                              * PART_FLOATS;
#pragma unroll 1
            for (int k = 0; k < nseg; ++k) {
                const Segment sg = k ? seg1 : seg0;
                const int row0 = (sg.b * CONSUMERS + wg) * MTILE;
                float o[64];
                if (it == 0) {          // m0: the queries themselves
                    load_rows(o, qrows, row0, nq, r, q);
                    store_m<M_HI_REGS>(o, my_m, r, q, wg);
                } else if (k == 1) {    // m of the second row block
                    const float* sp = spill + wg * MTILE * D + tid * 4;
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
                        const float4 v = __ldcg(reinterpret_cast<const float4*>(
                            sp + i * 512));
                        o[4 * i] = v.x; o[4 * i + 1] = v.y;
                        o[4 * i + 2] = v.z; o[4 * i + 3] = v.w;
                    }
                    store_m<M_HI_REGS>(o, my_m, r, q, wg);
                }
                float rs0, rs1;
                segment_tiles<false, M_HI_REGS>(o, rs0, rs1, my_m, x_smem,
                                                full_bar, empty_bar, stage,
                                                phase, sg.t0, sg.t1, nk, q, c,
                                                lane);
                if (sg.contrib == 1) {   // then this is the only segment
                    finish_rows(o, rs0, rs1, last ? TO_OUT : TO_SMEM, my_m,
                                spill, out, row0, nq, r, q, wg, tid);
                    continue;
                }
                // publish this block's partial of the row block
                float* part = ws_it + ((size_t)sg.b * slots + sg.slot)
                                      * PART_FLOATS;
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    *reinterpret_cast<float4*>(part + part_o + i * 512) =
                        make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2],
                                    o[4 * i + 3]);
                part[part_rs] = rs0;
                part[part_rs + 128] = rs1;
                consumers_barrier();
                if (threadIdx.x == 0) signal(counters + sg.b);
            }
            // gather every shared row block's partials, in slot order in
            // every contributor, so that all of them go on with the same m;
            // the second segment first, whose m goes to the spill, so that
            // the first's m can go straight to shared memory
#pragma unroll 1
            for (int k = nseg - 1; k >= 0; --k) {
                const Segment sg = k ? seg1 : seg0;
                if (sg.contrib == 1) continue;
                if (threadIdx.x == 0)
                    wait_count(counters + sg.b, (it + 1) * sg.contrib);
                consumers_barrier();
                float o[64];
#pragma unroll
                for (int i = 0; i < 64; ++i) o[i] = 0.f;
                float rs0 = 0.f, rs1 = 0.f;
                for (int j = 0; j < sg.contrib; ++j) {
                    const float* part = ws_it + ((size_t)sg.b * slots + j)
                                                * PART_FLOATS;
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
                        const float4 v = __ldcg(reinterpret_cast<const float4*>(
                            part + part_o + i * 512));
                        o[4 * i] += v.x; o[4 * i + 1] += v.y;
                        o[4 * i + 2] += v.z; o[4 * i + 3] += v.w;
                    }
                    rs0 += __ldcg(part + part_rs);
                    rs1 += __ldcg(part + part_rs + 128);
                }
                const int row0 = (sg.b * CONSUMERS + wg) * MTILE;
                normalize_rows(o, rs0, rs1);
                const Dest dest = last ? (sg.slot == 0 ? TO_OUT : NOWHERE)
                                       : (k == 1 ? TO_SPILL : TO_SMEM);
                store_rows(o, dest, my_m, spill, out, row0, nq, r, q, wg,
                           tid);
            }
        }
    }
}

// ---- The operand probe (chip_smoke.py phase 6; no path runs it). Both
// consumer warpgroups of a block repeat one key tile's score product, its
// update product, or both, `tiles` times against m and one key tile held
// in shared memory: no producer, no exponentials, so that the time is the
// products' and their operands' alone. The score product comes in four
// operand layouts, each the same 3 x 64 x 16 x 128 FMA a tile:
//   PROBE_SS3    48 SS m64n16k8: m hi and lo from shared memory, the tile's
//                hi and lo rows as two operands (m hi read twice a k-step);
//   PROBE_N32    16 SS m64n32k8 (m hi against the tile's hi and lo rows as
//                one operand) + 16 SS m64n16k8 (m lo against hi): the exit;
//   PROBE_RS_HI  PROBE_N32 with m hi from registers: the fixed-count kernel;
//   PROBE_RS     PROBE_N32 with m hi and lo from registers;
// with UPDATE, the update's 6 RS m64n128k8 (issue_update) follow, as in
// the kernel.
enum ProbeScore { PROBE_NONE, PROBE_SS3, PROBE_N32, PROBE_RS_HI, PROBE_RS };
constexpr size_t PROBE_SMEM_BYTES = 1024 + CONSUMERS * M_WG_BYTES
                                  + TILE_BYTES;

template <int SCORE, bool UPDATE>
__global__ void __launch_bounds__(CONSUMERS * 128, 1)
operand_probe_kernel(long long* __restrict__ cycles, int tiles) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    // small values that tf32 holds whole, so no product is a denormal
    for (uint32_t i = threadIdx.x; i < (PROBE_SMEM_BYTES - 1024) / 4;
         i += blockDim.x)
        asm volatile("st.shared.b32 [%0], %1;" :: "r"(base + 4 * i),
                     "r"(__float_as_uint(0.0625f * (float)(i % 13) - 0.375f))
                     : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const uint32_t m_base = base + wg * M_WG_BYTES;
    const uint32_t x_base = base + CONSUMERS * M_WG_BYTES;
    constexpr bool HI_REGS = SCORE == PROBE_RS_HI || SCORE == PROBE_RS;
    float s[16], o[64];
    uint32_t ph[8], pl[8], mh[64], ml[64];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        o[i] = 0.f;
        mh[i] = __float_as_uint(0.125f * (float)((tid + i) % 5));
        ml[i] = __float_as_uint(0.0009765625f * (float)((tid + i) % 3));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        ph[i] = __float_as_uint(0.25f * (float)((tid + i) % 7));
        pl[i] = __float_as_uint(0.0001220703125f * (float)((tid + i) % 3));
    }
    const long long t0 = clock64();
    for (int t = 0; t < tiles; ++t) {
        // the operands' addresses are computed a tile, as the kernel's ring
        // slots are, and not hoisted out of the loop
        uint32_t xs = x_base, m = m_base;
        asm volatile("" : "+r"(xs), "+r"(m));
        reg_fence(s);
        if constexpr (UPDATE) reg_fence(o);
        if constexpr (HI_REGS) reg_fence(mh);
        if constexpr (SCORE == PROBE_RS) reg_fence(ml);
        wg_fence();
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const uint32_t om = (k >> 2) * M_KBLK + (k & 3) * 32;
            const uint64_t m_hi = smem_desc(m + om);
            const uint64_t m_lo = smem_desc(m + M_HALF + om);
            const uint32_t ox = xs + (k >> 2) * X_KBLK + (k & 3) * 32;
            const uint64_t x = smem_desc(ox);   // hi rows, then lo rows
            if constexpr (SCORE == PROBE_SS3) {
                mma_ss_n16(low_cols(s), m_hi, x, k > 0);
                mma_ss_n16(low_cols(s), m_hi, smem_desc(ox + TILE * 128), 1);
                mma_ss_n16(low_cols(s), m_lo, x, 1);
            } else if constexpr (SCORE == PROBE_N32) {
                mma_ss_n32(s, m_hi, x, k > 0);
            } else if constexpr (HI_REGS) {
                mma_rs_n32(s, mh[4 * k], mh[4 * k + 1], mh[4 * k + 2],
                           mh[4 * k + 3], x, k > 0);
            }
            if constexpr (SCORE == PROBE_N32 || SCORE == PROBE_RS_HI)
                mma_ss_n16(low_cols(s), m_lo, x, 1);
            if constexpr (SCORE == PROBE_RS)
                mma_rs_n16(low_cols(s), ml[4 * k], ml[4 * k + 1],
                           ml[4 * k + 2], ml[4 * k + 3], x);
        }
        if constexpr (UPDATE) issue_update(o, ph, pl, xs);
        wg_commit();
        wg_wait<0>();
        reg_fence(s);
        if constexpr (UPDATE) reg_fence(o);
    }
    const long long t1 = clock64();
    if (tid == 0) cycles[blockIdx.x * CONSUMERS + wg] = t1 - t0;
    float keep = 0.f;   // the products' results stay live
#pragma unroll
    for (int i = 0; i < 16; ++i) keep += s[i];
#pragma unroll
    for (int i = 0; i < 64; ++i) keep += o[i];
    if (keep == 1234.5f) cycles[0] = -1;
}

template <int SCORE, bool UPDATE>
int probe_launch(long long* cycles, int tiles, int grid, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(
        operand_probe_kernel<SCORE, UPDATE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PROBE_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    operand_probe_kernel<SCORE, UPDATE>
        <<<grid, CONSUMERS * 128, PROBE_SMEM_BYTES, s>>>(cycles, tiles);
    return (int)cudaGetLastError();
}

}  // namespace

// The operand probe: `grid` blocks of two consumer warpgroups, each
// running `tiles` tiles of mode `mode` (kernels.MS_TF32_PROBE's order: the
// four score layouts, the update, then each score layout with the update);
// cycles: grid x 2 int64, the clock64 cycles of each warpgroup's loop.
extern "C" int ms_tf32_operand_probe(void* cycles, int mode, int tiles,
                                     int grid, void* stream) {
    long long* c = static_cast<long long*>(cycles);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case 0: return probe_launch<PROBE_SS3, false>(c, tiles, grid, s);
        case 1: return probe_launch<PROBE_N32, false>(c, tiles, grid, s);
        case 2: return probe_launch<PROBE_RS_HI, false>(c, tiles, grid, s);
        case 3: return probe_launch<PROBE_RS, false>(c, tiles, grid, s);
        case 4: return probe_launch<PROBE_NONE, true>(c, tiles, grid, s);
        case 5: return probe_launch<PROBE_SS3, true>(c, tiles, grid, s);
        case 6: return probe_launch<PROBE_N32, true>(c, tiles, grid, s);
        case 7: return probe_launch<PROBE_RS_HI, true>(c, tiles, grid, s);
        case 8: return probe_launch<PROBE_RS, true>(c, tiles, grid, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K1 f32 (queries = keys) and K5 (one iteration, queries apart). q: the f32
// queries [nq, 128]; xt: the keys as tf32 tiles (the wrapper's
// ms_tiles_tf32: rows zero-padded to a multiple of 16, 32 KB a 16-row
// tile); out: [nq, 128] f32; inv2b2: one f32 on the device; iterations >= 1.
// grid: blocks, at least ceil(nq / 128) and at most ceil(nq / 128)
// ceil(nk / 16); above ceil(nq / 128) they share row blocks and must all be
// resident at once (a cooperative launch, which fails rather than
// deadlock), adding partial sums through `ws` (2 x ceil(nq / 128) x slots x
// PART_FLOATS f32 of partials, then grid x 16,384 f32 of spilled m) and
// `counters` (ceil(nq / 128) u32, zero); slots: the most blocks that share
// a row block. Returns cudaGetLastError() after the launch, or the reason
// it refused to launch.
extern "C" int ms_iterations_tf32(const void* q, const void* xt, void* out,
                                  const void* inv2b2, void* ws,
                                  void* counters, int nq, int nk,
                                  int iterations, int grid, int slots,
                                  void* stream) {
    const int n_tiles = (nk + TILE - 1) / TILE;
    const int n_blocks = (nq + ROWS - 1) / ROWS;
    if (nq <= 0 || nk <= 0 || iterations < 1 || grid < n_blocks
        || (long long)grid > (long long)n_blocks * n_tiles || slots < 1)
        return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, ms_tf32_kernel);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg can only hand the consumers what the launch allocated
    if (attr.numRegs < REGS_AT_LAUNCH)
        return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(ms_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const float* q_ = static_cast<const float*>(q);
    const uint8_t* xt_ = static_cast<const uint8_t*>(xt);
    float* out_ = static_cast<float*>(out);
    const float* inv2b2_ = static_cast<const float*>(inv2b2);
    float* ws_ = static_cast<float*>(ws);
    unsigned* counters_ = static_cast<unsigned*>(counters);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (grid == n_blocks) {
        ms_tf32_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
            q_, xt_, out_, inv2b2_, ws_, counters_, nq, nk, n_tiles, n_blocks,
            iterations, slots);
    } else {
        void* args[] = {&q_, &xt_, &out_, &inv2b2_, &ws_, &counters_,
                        (void*)&nq, (void*)&nk, (void*)&n_tiles,
                        (void*)&n_blocks, &iterations, &slots};
        err = cudaLaunchCooperativeKernel((const void*)ms_tf32_kernel, grid,
                                          THREADS, args, SMEM_BYTES, s);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

// K1 exit, f32 mode (tol > 0; queries = keys = q, n rows): as
// ms_iterations_tf32, and each 128-row block stops once max |new m - m|
// over its rows < n is <= tol (ms_exit.cuh). part: 2 x grid x PART_FLOATS
// f32 (two partials per grid block: its run's first and last segments);
// mstate: ceil(n / 128) x 128 x 128 f32 (each row block's m); iters:
// ceil(n / 128) int32, zero, receiving the iterations each row block ran;
// counters: 1 + 2 x grid u32, zero (the grid barrier, a flag per partial).
// grid: at most one block per SM and per EXIT_MIN_RUN key tiles of the row
// blocks, a cooperative launch.
extern "C" int ms_iterations_tf32_exit(const void* q, const void* xt,
                                       void* out, const void* inv2b2,
                                       void* part, void* mstate, void* iters,
                                       void* counters, int n, int iterations,
                                       int grid, float tol, void* stream) {
    return exit_launch(xt, q, out, inv2b2, part, mstate, iters, counters, n,
                       (n + TILE - 1) / TILE, iterations, grid, tol, stream);
}
