// K1, bf16 mode: all mean-shift iterations of a row tile on Hopper's tensor
// cores (wgmma), with X streamed by the bulk-copy engine.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, mean_shift_iterations_pallas
// with bf16_dots=True (pallas_call at :212, kernel body
// _make_ms_multi_kernel :107-182). The f32 mode stays on the FFMA kernel of
// ms_iterations.cu.
//
// Computes, for `iterations` steps with m0 = X (rows unit-norm, D = 128):
//   s = bf16(m) . bf16(X)^T               (f32 accumulation)
//   K = exp((2 s - 2) * inv2b2)           (columns >= n masked to 0)
//   new_m = (bf16(K) @ bf16(X)) / (rowsum_f32(K) + 1e-12)
//   m = new_m / (|new_m| + 1e-12)
// and writes the f32 m of the last iteration.
//
// Bound on this card: operations. One iteration is two N x N x 128
// products, 4 N^2 D FLOP, so 2.56e12 FLOP per 50-iteration call at
// N = 10,000: 2.59 ms at the 989 TFLOP/s of bf16. The N^2 exponentials per
// iteration (5e9 per call) are a second floor of about 1.2 ms on the MUFU
// units (16 per clock per SM). X in bf16 is 2.56 MB and stays in L2.
//
// Design. The wrapper casts X once to bf16 and lays it out in 64-row tiles
// whose bytes are already wgmma's 128-byte-swizzled canonical layout (two
// 64-column halves of 64 rows x 128 bytes; 16-byte chunk j of row r stored
// at chunk j ^ (r % 8)), so one 1-D cp.async.bulk per tile lands it ready
// for the tensor cores; no tensor map is needed. A block has two consumer
// warpgroups, each owning 64 rows of m for all iterations, and one producer
// warp that keeps a ring of STAGES X tiles in flight, completion on
// mbarriers; both consumers read every tile. m lives in shared memory only
// as bf16 in the same swizzled layout, the A operand of the first product.
// Per X tile a consumer runs
//   S = m . X^T     8 x SS-wgmma m64n64k16 (X tile K-major),
//   P = ex2((s - 1) c), c = 2 inv2b2 log2(e): one FFMA + one MUFU a score,
//                   the f32 row sums kept per thread, masked in the last tile,
//   O += P . X      4 x RS-wgmma m64n128k16, P packed to bf16 in registers
//                   as the A fragment, the same X tile read MN-major.
// The tiles are software-pipelined as FlashAttention-3 does: the next
// tile's S is issued together with this tile's update, and its
// exponentials run, in place on the retired S accumulator, while the tensor
// cores do the update; P is packed only after the update retired, since
// ptxas serialises every wgmma (C7513/C7514) when registers of an
// unfinished one are written. The two warpgroups also interleave on the
// SM. After the last tile of an iteration the row sums are reduced across
// the quad, O / rowsum is normalised with quad shuffles, and the bf16 m goes
// back to shared memory, followed by fence.proxy.async (wgmma reads through
// the async proxy) and a warpgroup barrier. setmaxnreg moves registers from
// the producer warpgroup to the consumers (O 64 + S 32 + P 16 a thread).
//
// Filling the card: 10,000 rows are only 79 blocks of 128 rows on 132 SMs.
// So an iteration's work is cut into units (a 128-row block against one X
// tile, 79 x 157 of them) and block g of a 132-block grid takes the g-th
// 132nd of them in row-block-major order: a run within at most two row
// blocks, each row block shared by two or three grid blocks. A grid block
// publishes its partial O and row sums of each shared row block to a
// workspace in L2 (double-buffered by iteration) and adds 1 to the row
// block's counter with a GPU-scope release; then it waits for the counter
// to reach (iteration + 1) x sharers and adds all partials, in the same
// order in every sharer, so all of them go on with the same m. Every block
// must be resident for those waits, so this grid is a cooperative launch.
// With as many row blocks as SMs there is one block per row block and no
// exchange (the wrapper's ms_plan). Clusters sharing partials through
// distributed shared memory were measured first and lost: at 10,000 rows
// two or more cluster waves cost more than the split saved.
// A wait that never ends traps instead of hanging the card.
//
// The early exit (tol > 0; the TPU kernel's early_exit=True variant,
// _make_ms_multi_kernel :165-180, chosen at :213) is the EXIT instantiation
// of the same kernel, with the rule and its helpers in ms_exit.cuh; the
// tol = 0 one keeps its code. The previous m of the delta lives in an L2
// workspace, since shared memory holds m only as bf16; a row block that
// leaves writes its f32 m and the iterations it ran. All sharers of a row
// block leave at the same iteration, so no waiter is left on a counter.
// The producer learns each iteration's decisions behind an mbarrier before
// it streams the next iteration's tiles, so no bulk copy is in flight when
// the block leaves (the price: no prefetch across an iteration's end).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                        // feature width
constexpr int TILE = 64;                      // rows of an X tile and of a consumer's m
constexpr int CONSUMERS = 2;                  // consumer warpgroups per block
constexpr int ROWS = TILE * CONSUMERS;        // rows of m per block
constexpr int STAGES = 4;                     // X tiles in flight
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int REGS_AT_LAUNCH = 168;           // 65,536 / 384, a multiple of 8
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;            // 128 x 40 + 256 x 232 <= 384 x 168
constexpr uint32_t TILE_BYTES = TILE * D * 2; // 16 KB
constexpr uint32_t HALF_BYTES = TILE * 128;   // one 64-column half of a tile
// a block's partial O and row sums in the workspace, per consumer: 16
// float4 and 2 floats per thread, each array in thread order
constexpr int PART_FLOATS = CONSUMERS * (TILE * D + 2 * 128);
// [m of up to two row blocks x consumers][X ring][full][empty][m_full]
constexpr size_t SMEM_BYTES = 1024 + (2 * CONSUMERS + STAGES) * TILE_BYTES
                            + 8 * (2 * STAGES + 1);

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

// wgmma shared-memory descriptor, 128-byte swizzle. Byte offsets: lbo
// between 64-element blocks along M/N (MN-major; unused for K-major), sbo
// between 8-row (K-major) or 8-k (MN-major) groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
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

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (bf16 pairs), B
// from shared memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// bf16 pair: lo in the low half (the lower column), hi in the high half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void wg_barrier(int id) {
    asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// S = m . X_t^T over D = 128: 8 k-steps of 16 through both 64-column
// halves of the swizzled tiles (K-major A and B).
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t m,
                                             uint32_t xs) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint32_t off = (k >> 2) * HALF_BYTES + (k & 3) * 32;
        mma_ss_n64(s, smem_desc(m + off, 16, 1024),
                   smem_desc(xs + off, 16, 1024), k > 0);
    }
}

// O += P . X_t over the tile's 64 rows: 4 k-steps of 16 rows, the tile
// read MN-major (LBO = the distance between its two 64-column halves).
__device__ __forceinline__ void issue_update(float (&o)[64],
                                             const uint32_t (&p)[16],
                                             uint32_t xs) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
        mma_rs_n128(o, p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3],
                    smem_desc(xs + k * 16 * 128, HALF_BYTES, 1024));
}

// P = exp((2 s - 2) inv2b2) = ex2((s - 1) c) of tile t, masked to columns
// < n, into the row sums (f32) and the bf16 A fragment p. s[4 j + e] is row
// r + 8 (e / 2), column 8 j + 2 q + (e % 2) of the tile; so are the pairs
// (s[2 i], s[2 i + 1]) of p[i], the layout wgmma's A fragment takes.
__device__ __forceinline__ void exp_tile(float (&s)[32], float& rs0,
                                         float& rs1, int t, int n, int q,
                                         float c) {
    if (t * TILE + TILE > n) {
        const int col0 = t * TILE + 2 * q;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int col = col0 + 8 * (i >> 2) + (i & 1);
            s[i] = col < n ? ex2(fmaf(s[i], c, -c)) : 0.f;
        }
    } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], c, -c));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
}

__device__ __forceinline__ void pack_tile(const float (&s)[32],
                                          uint32_t (&p)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// The two consumer warpgroups (256 threads), named barrier 3.
__device__ __forceinline__ void consumers_barrier() {
    asm volatile("bar.sync 3, %0;" :: "n"(CONSUMERS * 128) : "memory");
}

// Byte offset of element (row, col) in a swizzled 64 x 128 bf16 tile.
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
    return (col >> 6) * HALF_BYTES + row * 128
         + ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// The work of an iteration is n_blocks x n_tiles units (a 128-row block of
// m against a 64-row tile of X), in row-block-major order; block g of the
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

// One row block's share of this grid block's units: X tiles [t0, t1) of
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

// new_m = O / (rowsum + 1e-12), m = new_m / (|new_m| + 1e-12) for this
// thread's rows r, r + 8 of the warpgroup's 64; `o` and the row sums hold
// whole sums over X, the row sums not yet over the quad. Writes the f32
// rows to `out` after the last iteration (if `write_out`), else the bf16 m
// into the swizzled A tile at `m_tile`.
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

// The normalised rows to `out` (f32, rows < n) if `last` and `write_out`,
// or, if not `last`, as bf16 into the swizzled A tile at `m_tile`.
__device__ __forceinline__ void store_rows(const float (&o)[64],
                                           uint32_t m_tile,
                                           float* __restrict__ out, int row0,
                                           int n, int r, int q, int wg,
                                           bool last, bool write_out) {
    if (last) {
        if (!write_out) return;
        const int g0 = row0 + r, g1 = g0 + 8;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * q;
            if (g0 < n)
                *reinterpret_cast<float2*>(out + (size_t)g0 * D + col) =
                    make_float2(o[4 * j], o[4 * j + 1]);
            if (g1 < n)
                *reinterpret_cast<float2*>(out + (size_t)g1 * D + col) =
                    make_float2(o[4 * j + 2], o[4 * j + 3]);
        }
        return;
    }
    // the bf16 m back into the swizzled A tile; the async proxy (wgmma)
    // must see these generic-proxy stores
    wg_barrier(1 + wg);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q;
        asm volatile("st.shared.b32 [%0], %1;"
                     :: "r"(m_tile + tile_offset(r, col)),
                        "r"(pack_bf16(o[4 * j], o[4 * j + 1]))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;"
                     :: "r"(m_tile + tile_offset(r + 8, col)),
                        "r"(pack_bf16(o[4 * j + 2], o[4 * j + 3]))
                     : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_barrier(1 + wg);
}

__device__ __forceinline__ void finish_rows(float (&o)[64], float rs0,
                                            float rs1, uint32_t m_tile,
                                            float* __restrict__ out, int row0,
                                            int n, int r, int q, int wg,
                                            bool last, bool write_out) {
    normalize_rows(o, rs0, rs1);
    store_rows(o, m_tile, out, row0, n, r, q, wg, last, write_out);
}

#include "ms_exit.cuh"

template <bool EXIT>
__global__ void __launch_bounds__(THREADS, 1)
ms_tc_kernel(const uint8_t* __restrict__ xt, float* __restrict__ out,
             const float* __restrict__ inv2b2_ptr, float* __restrict__ ws,
             unsigned* __restrict__ counters, int n, int n_tiles,
             int n_blocks, int iterations, int slots,
             const float* __restrict__ x32, float* __restrict__ prev,
             int* __restrict__ iters, float tol) {
    extern __shared__ uint8_t smem_raw[];
    // tiles 1024-byte aligned, as the 128-byte swizzle requires
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t m_smem = base;
    const uint32_t x_smem = base + 2 * CONSUMERS * TILE_BYTES;
    const uint32_t full_bar = x_smem + STAGES * TILE_BYTES;
    const uint32_t empty_bar = full_bar + 8 * STAGES;
    const uint32_t m_full = empty_bar + 8 * STAGES;
    const ExitSmem ex = exit_smem(smem_raw, m_full + 8);   // exit variant
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
        mbar_init(m_full, 1);
        if (EXIT) mbar_init(ex.bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        // ---- producer: one thread loads m of each segment's row block and
        // streams the segments' X tiles, every iteration; in the exit
        // variant only those of row blocks still iterating, as the
        // consumers decided at the end of the last iteration
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        if (tid == 0) {
            mbar_expect_tx(m_full, nseg * CONSUMERS * TILE_BYTES);
            for (int k = 0; k < nseg; ++k)
                bulk_load(m_smem + k * CONSUMERS * TILE_BYTES,
                          xt + (size_t)(b0 + k) * CONSUMERS * TILE_BYTES,
                          CONSUMERS * TILE_BYTES, m_full);
            int stage = 0;
            uint32_t phase = 0;
            int done0 = 0, done1 = 0;
            for (int it = 0; it < iterations; ++it) {
                if (EXIT && it > 0
                    && await_decisions(ex, it, nseg, done0, done1))
                    break;
                for (int k = 0; k < nseg; ++k) {
                    if (EXIT && (k ? done1 : done0)) continue;
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
        // this thread's floats in a workspace partial
        const int part_o = wg * (TILE * D + 2 * 128) + tid * 4;
        const int part_rs = wg * (TILE * D + 2 * 128) + TILE * D + tid;
        mbar_wait(m_full, 0);

        // exit variant: whether each segment's row block has left the loop
        bool done0 = false, done1 = false;
        int stage = 0;
        uint32_t phase = 0;
        for (int it = 0; it < iterations; ++it) {
            const bool last = it == iterations - 1;
            float* ws_it = ws + (size_t)(it & 1) * n_blocks * slots
                              * PART_FLOATS;
#pragma unroll 1
            for (int k = 0; k < nseg; ++k) {
                if (EXIT && (k ? done1 : done0)) continue;
                const Segment sg = k ? seg1 : seg0;
                const uint32_t my_m = m_smem + (k * CONSUMERS + wg) * TILE_BYTES;
                float o[64];
#pragma unroll
                for (int i = 0; i < 64; ++i) o[i] = 0.f;
                float rs0 = 0.f, rs1 = 0.f;   // row sums of rows r, r + 8

                // Software pipeline over the segment's tiles: the scores of
                // the next tile are issued with the update of this one, and
                // their exponentials run while the tensor cores do the
                // update; they become the next A fragment only after the
                // update retired.
                float s[32];
                uint32_t p[16];
                mbar_wait(full_bar + 8 * stage, phase);
                wg_fence();
                issue_scores(s, my_m, x_smem + stage * TILE_BYTES);
                wg_commit();
                wg_wait<0>();
                reg_fence(s);
                exp_tile(s, rs0, rs1, sg.t0, n, q, c);
                pack_tile(s, p);
                for (int t = sg.t0; t + 1 < sg.t1; ++t) {
                    const int cur = stage;
                    if (++stage == STAGES) { stage = 0; phase ^= 1; }
                    mbar_wait(full_bar + 8 * stage, phase);
                    reg_fence(s);
                    reg_fence(p);
                    reg_fence(o);
                    wg_fence();   // every register write lands before wgmma
                    issue_scores(s, my_m, x_smem + stage * TILE_BYTES);
                    wg_commit();
                    issue_update(o, p, x_smem + cur * TILE_BYTES);
                    wg_commit();
                    wg_wait<1>();   // the scores; the update may still run
                    reg_fence(s);
                    exp_tile(s, rs0, rs1, t + 1, n, q, c);
                    wg_wait<0>();
                    reg_fence(o);
                    reg_fence(p);
                    if (lane == 0) mbar_arrive(empty_bar + 8 * cur);
                    pack_tile(s, p);
                }
                reg_fence(p);
                reg_fence(o);
                wg_fence();
                issue_update(o, p, x_smem + stage * TILE_BYTES);
                wg_commit();
                wg_wait<0>();
                reg_fence(o);
                if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
                if (++stage == STAGES) { stage = 0; phase ^= 1; }

                const int row0 = (sg.b * CONSUMERS + wg) * TILE;
                if (sg.contrib == 1) {
                    if (EXIT) {
                        normalize_rows(o, rs0, rs1);
                        const bool leave = decide<TILE>(
                            o, x32, prev, ex.red, iters, sg.b, true, g, k,
                            it, iterations, row0 + r, n, q, wg, tid, tol);
                        (k ? done1 : done0) = leave;
                        store_rows(o, my_m, out, row0, n, r, q, wg,
                                   last || leave, true);
                    } else {
                        finish_rows(o, rs0, rs1, my_m, out, row0, n, r, q,
                                    wg, last, true);
                    }
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
            // every contributor, so that all of them go on with the same m
#pragma unroll 1
            for (int k = 0; k < nseg; ++k) {
                const Segment sg = k ? seg1 : seg0;
                if (sg.contrib == 1 || (EXIT && (k ? done1 : done0))) continue;
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
                const int row0 = (sg.b * CONSUMERS + wg) * TILE;
                const uint32_t my_m =
                    m_smem + (k * CONSUMERS + wg) * TILE_BYTES;
                if (EXIT) {
                    normalize_rows(o, rs0, rs1);
                    const bool leave = decide<TILE>(
                        o, x32, prev, ex.red, iters, sg.b, sg.slot == 0, g, k,
                        it, iterations, row0 + r, n, q, wg, tid, tol);
                    (k ? done1 : done0) = leave;
                    store_rows(o, my_m, out, row0, n, r, q, wg, last || leave,
                               sg.slot == 0);
                } else {
                    finish_rows(o, rs0, rs1, my_m, out, row0, n, r, q, wg,
                                last, sg.slot == 0);
                }
            }
            if (EXIT) {
                publish_decisions(ex, done0, done1);
                if (done0 && (nseg == 1 || done1)) break;
            }
        }
    }
}

// One launch of the EXIT or the fixed-count kernel (see the entry points).
template <bool EXIT>
int launch(const void* xt, void* out, const void* inv2b2, void* ws,
           void* counters, int n, int iterations, int grid, int slots,
           const void* x32, void* prev, void* iters, float tol,
           void* stream) {
    const int n_tiles = (n + TILE - 1) / TILE;
    const int n_blocks = (n + ROWS - 1) / ROWS;
    if (n <= 0 || iterations < 1 || grid < n_blocks
        || (long long)grid > (long long)n_blocks * n_tiles || slots < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = SMEM_BYTES + (EXIT ? EXIT_SMEM_EXTRA : 0);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, ms_tc_kernel<EXIT>);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg can only hand the consumers what the launch allocated
    if (attr.numRegs < REGS_AT_LAUNCH) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(ms_tc_kernel<EXIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const uint8_t* xt_ = static_cast<const uint8_t*>(xt);
    float* out_ = static_cast<float*>(out);
    const float* inv2b2_ = static_cast<const float*>(inv2b2);
    float* ws_ = static_cast<float*>(ws);
    unsigned* counters_ = static_cast<unsigned*>(counters);
    const float* x32_ = static_cast<const float*>(x32);
    float* prev_ = static_cast<float*>(prev);
    int* iters_ = static_cast<int*>(iters);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (grid == n_blocks) {
        ms_tc_kernel<EXIT><<<grid, THREADS, smem, s>>>(
            xt_, out_, inv2b2_, ws_, counters_, n, n_tiles, n_blocks,
            iterations, slots, x32_, prev_, iters_, tol);
    } else {
        void* args[] = {&xt_, &out_, &inv2b2_, &ws_, &counters_, (void*)&n,
                        (void*)&n_tiles, (void*)&n_blocks, &iterations,
                        &slots, &x32_, &prev_, &iters_, &tol};
        err = cudaLaunchCooperativeKernel((const void*)ms_tc_kernel<EXIT>,
                                          grid, THREADS, args, smem, s);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// K1, bf16 mode. xt: X as bf16 tiles (the wrapper's ms_tiles_bf16: rows
// zero-padded to a multiple of 128, 16 KB a 64-row tile, swizzled), out:
// [n, 128] f32, inv2b2: one f32 on the device; iterations >= 1. grid:
// blocks, at least ceil(n / 128) and at most ceil(n / 128) ceil(n / 64);
// above ceil(n / 128) they share row blocks and must all be resident at
// once (a cooperative launch, which fails rather than deadlock), adding
// partial sums through `ws` (2 x ceil(n / 128) x slots x PART_FLOATS f32)
// and `counters` (ceil(n / 128) u32, zero); slots: the most blocks that
// share a row block. Returns cudaGetLastError() after the launch, or the
// reason it refused to launch.
extern "C" int ms_iterations_tc(const void* xt, void* out, const void* inv2b2,
                                void* ws, void* counters, int n,
                                int iterations, int grid, int slots,
                                void* stream) {
    return launch<false>(xt, out, inv2b2, ws, counters, n, iterations, grid,
                         slots, nullptr, nullptr, nullptr, 0.f, stream);
}

// K1 exit, bf16 mode (tol > 0): as ms_iterations_tc, and each 128-row block
// stops once max |new m - m| over its rows < n is <= tol. x32: X in f32,
// [n, 128]; prev: grid x 2 x 128 x 128 f32 of workspace (each grid block's
// previous m of its up to two row blocks); iters: ceil(n / 128) int32, the
// iterations each row block ran.
extern "C" int ms_iterations_tc_exit(const void* xt, const void* x32,
                                     void* out, const void* inv2b2, void* ws,
                                     void* prev, void* iters, void* counters,
                                     int n, int iterations, int grid,
                                     int slots, float tol, void* stream) {
    if (!(tol > 0.f)) return (int)cudaErrorInvalidValue;
    return launch<true>(xt, out, inv2b2, ws, counters, n, iterations, grid,
                        slots, x32, prev, iters, tol, stream);
}
