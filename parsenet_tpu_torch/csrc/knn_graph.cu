// K6: the DGCNN's exact k-nearest-neighbour graphs, distances and top-k in
// one launch.
//
// Replaces no TPU kernel: the JAX package builds these graphs in XLA (a
// score product and lax.approx_max_k, exact lax.top_k off the TPU). The
// port's plain route (ops/knn.py: knn, knn_points_normals) writes every
// [B, chunk, N] score block to device memory, runs a few elementwise passes
// over it and then torch.topk's multi-pass radix select. This kernel keeps
// each score in registers and each row's running top-k in a short list of
// its own, so no score matrix reaches device memory.
//
// What it computes, for x [B, N, C] f32 and the squared norms nrm [B, N]
// (torch.sum(v * v, -1) as the plain route computes them, passed in so
// their bits are the plain route's; +inf on padding), per cloud b and query
// row i:
//   plain metric (C = 3 or 64):   score_ij = (2 s_ij - nrm_i) - nrm_j,
//                                 s_ij = <x_i, x_j>
//   joint metric (C = 6, points then normals; nrm of the points):
//       d_p = (nrm_i - 2 s_p) + nrm_j,  d_n = 2 - 2 s_n,
//       score_ij = -(d_p (1 + d_n))
// and writes the indices of the k largest scores of the row, k <= 128, in
// order. Each score is the plain route's bit for bit: each inner product
// is one chain of FMAs over the channels in order 0..C-1 from +0, as the
// SIMT sgemm of `q @ x^T` accumulates it (TF32 stays off), and the
// epilogue rounds each operation in torch's order (__fmul_rn, __fsub_rn,
// __fadd_rn: nvcc contracts nothing into an FMA).
//
// Tie rule (the order torch.topk(..., sorted=True) gives on the card at
// k = 80, held by tests/test_torch_knn_graph_card.py): score descending,
// and among equal scores index ascending, at every k (torch.topk was seen
// to order a tie otherwise at k = 17; this rule is lax.top_k's, the JAX
// package's). Each (score, j) is one 64-bit key, the score's bits made
// order-preserving in the high word (the radix select's order, -0.0 below
// +0.0, and as there a NaN above every number: high word 0xffffffff) and
// ~j in the low word, so no two keys tie and the k largest keys, sorted,
// are the row. torch.topk's final sort compares floats, in which -0.0
// equals +0.0: the two orders differ only where both zeros score in one
// row, which neither metric produces (the joint metric's zero is -0.0, the
// plain one's +0.0). Padded candidates score -inf and are never taken.
//
// Bound on this card: operations. A pair costs C FFMA and the epilogue
// (3 operations plain, 8 joint) and a compare. At e2e-segment's shape (4
// clouds of 10,000 points, a request's three graphs) that is 2 x 4 x 1e8 x
// 64 FFMA for the two 64-channel graphs and 4 x 1e8 x 6 for the joint one:
// 0.40 ms a shape at the 67 TFLOP/s FP32 rate, 0.191 ms a cloud for one
// 64-channel graph. The selection adds what the bound leaves out: on
// points in random order a row takes about k (1 + ln(N / k)) keys that beat
// its threshold, about 600 at N = 10,000 (a simulation of this buffer
// policy), and each costs a shared atomic and its share of a merge.
//
// Design. A block owns BM = 64 query rows of one cloud (grid: row blocks x
// clouds) and walks the cloud's candidates in tiles of BN = 64, staged
// through shared memory by cp.async, double-buffered: the next tile loads
// while this one is scored. The query rows stay in shared memory for the
// whole walk. Four warps; thread (ty, tx) computes the 4 x 8 scores of
// rows 4 ty.. and candidates 4 tx.. and 32 + 4 tx.. of the tile in
// registers, reading three float4 a channel (32 FFMA to 3 LDS.128).
// Rows 16w..16w+15 are scored by warp w alone, so a row's selection state
// is touched by one warp and needs no block barrier.
// Selection (the WarpSelect / BlockSelect design of Johnson, Douze and
// Jegou, "Billion-scale similarity search with GPUs", 2017): each row keeps
// its best KP = 128 keys so far, sorted, in a list in device memory (L2:
// read and written once a merge), and a threshold, the k-th of them, in
// registers. A thread whose scores all fall below their rows' thresholds
// (a float compare, the common case once rows have merged a few times)
// skips the rest; a score that beats its row's threshold (the exact key
// compare) is appended to the row's buffer of CAP = 120 keys in shared
// memory with a shared atomic. After each tile the warp merges each of its
// rows whose buffer could overflow on the next one (more than CAP - BN
// keys): the buffer is sorted by a bitonic network in registers on the
// smallest of 32, 64 or 128 keys that holds it (past the first tiles a
// buffer merges holding just over CAP - BN = 56 keys: the 64-key one),
// merged into the list (max against the reversed buffer, then a bitonic
// merge), and the threshold raised. At the end every row merges what is
// left and writes its first k indices. The channel loop is unrolled 16
// deep, not fully: fully unrolled (2,240 instructions at C = 64) it and
// the merges and appends beside it thrashed the instruction cache, and
// the 64-channel graph took 4.2 ms against 3.2 on an H100.
// Measured there (clock64 a phase; PERF.md §6): with
// selection the 64-channel graph at 4 x 10,000 takes 3.2 ms against 1.7
// ms for the same walk with every threshold at +inf (no appends, no
// merges), its time split about 51 / 27 / 21% between scoring, appends and
// merges; the walk alone runs the FFMA at about 45% of the card's rate.
// Tried and slower: 8 x 8 micro-tiles (two warps a block), per-slot
// ballots in place of the atomics, one atomic a thread-row, two rows
// merged at once, a buffer over 64 keys merged 64 at a time, every merge
// on the 128-key network, the merge inlined; no faster: candidates walked
// in the points' Morton order (fewer appends), a first tile written
// without atomics, merges triggered at 40 or 48 keys.
//
// Resources: shared memory 112,384 bytes a block at C = 64 (the row
// buffers 60 KB, the candidate tiles 32 KB, the queries 16 KB), so two
// blocks share an SM; registers 96-112 (32 accumulators, 4 norms, 4
// thresholds and their keys a thread; 12 keys a lane in a merge, a call
// of its own); `ptxas -v` (the build log, which chip_smoke.py phase 2
// checks) must show no spill.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows a block
constexpr int BN = 64;          // candidates a tile
constexpr int THREADS = 128;    // 4 warps; warp w owns rows 16w..16w+15
constexpr int TM = 4;           // rows of a thread's micro-tile
constexpr int TN = 8;           // candidates of a thread's micro-tile
constexpr int KP = 128;         // a row's list of best keys; k <= KP
constexpr int CAP = 120;        // a row's buffer of keys past its threshold
constexpr int WARP_ROWS = BM / (THREADS / 32);
#define NEG_INF __int_as_float(0xff800000)

typedef unsigned long long u64;

// The score's bits made order-preserving (the radix select's order, a NaN
// of either sign above +inf) above ~j: the larger key is the better
// neighbour.
__device__ __forceinline__ u64 make_key(float s, int j) {
    const unsigned b = __float_as_uint(s);
    const unsigned u = s != s ? 0xffffffffu
                              : b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
    return ((u64)u << 32) | (unsigned)(~j);
}

// max(a, b), NaN if either is: a row's NaN score must reach its buffer
__device__ __forceinline__ float max_nan(float a, float b) {
    float m;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
}

// The score of a key's high word (a NaN for a NaN's key).
__device__ __forceinline__ float key_score(u64 key) {
    const unsigned u = (unsigned)(key >> 32);
    return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One channel's operands of a thread's micro-tile from shared memory: its
// TM query rows (q, TM / 4 float4) and its TN = 8 candidates, 4 at x and 4
// at x + 32 (two float4).
__device__ __forceinline__ void load_operands(float (&av)[TM],
                                              float (&bv)[TN],
                                              const float* q,
                                              const float* x) {
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(q + 4 * h);
        av[4 * h] = a.x; av[4 * h + 1] = a.y;
        av[4 * h + 2] = a.z; av[4 * h + 3] = a.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float4 b = *reinterpret_cast<const float4*>(x + 32 * h);
        bv[4 * h] = b.x; bv[4 * h + 1] = b.y;
        bv[4 * h + 2] = b.z; bv[4 * h + 3] = b.w;
    }
}

// One compare-exchange step of a bitonic network across lanes: v and its
// partner `st` lanes away; the lane keeps the larger key where keep_max.
__device__ __forceinline__ u64 exchange(u64 v, int st, bool keep_max) {
    const u64 w = __shfl_xor_sync(0xffffffffu, v, st);
    return ((w > v) == keep_max) ? w : v;
}

// Sorts the first 32 G keys of v (key lane + 32 j in v[j], j < G) in
// descending order, a bitonic network: in-lane exchanges for strides of 32
// and more, shuffles below.
template <int G>
__device__ __forceinline__ void bitonic_sort(u64 (&v)[4], int lane) {
    constexpr int LOG = G == 1 ? 5 : G == 2 ? 6 : 7;   // log2(32 G)
#pragma unroll
    for (int ls = 1; ls <= LOG; ++ls) {
        const int sz = 1 << ls;
#pragma unroll
        for (int lt = ls - 1; lt >= 0; --lt) {
            const int st = 1 << lt;
            if (st >= 32) {
                const int js = st / 32;
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    if (j & js) continue;
                    const bool desc = ((32 * j) & sz) == 0;
                    const u64 a = v[j], b = v[j + js];
                    if ((a < b) == desc) { v[j] = b; v[j + js] = a; }
                }
            } else {
#pragma unroll
                for (int j = 0; j < G; ++j)
                    v[j] = exchange(v[j], st, ((lane & st) == 0)
                                    == (((lane + 32 * j) & sz) == 0));
            }
        }
    }
}

// Row r's buffer merged into its list by the whole warp, on the network of
// 32 G keys that holds the buffer: the KP best of both, sorted descending,
// left in c (key lane + 32 j in c[j]) and, unless last, written back to the
// row's list in device memory (lb, the block's lists); the buffer emptied
// and the threshold raised to the k-th key.
template <int G>
__device__ __forceinline__ void merge_g(u64 (&c)[4], u64* __restrict__ lb,
                                        const u64* __restrict__ buf,
                                        u64* __restrict__ thr_key,
                                        float* __restrict__ thr,
                                        int* __restrict__ cnt,
                                        int* __restrict__ merged, int r,
                                        int k, int lane, bool last) {
    const bool have = merged[r] != 0;
    const int n = cnt[r];
    u64 l[4], v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int p = lane + 32 * j;
        l[j] = have ? lb[(size_t)r * KP + p] : 0ull;
        v[j] = p < n ? buf[r * CAP + p] : 0ull;
    }
    bitonic_sort<G>(v, lane);
    // c[i] = max(list[i], buffer[KP - 1 - i]): the KP best, a bitonic
    // sequence; buffer key KP - 1 - (lane + 32 j) is lane 31 - lane's v[3 - j]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const u64 w = __shfl_xor_sync(0xffffffffu, v[3 - j], 31);
        c[j] = l[j] > w ? l[j] : w;
    }
#pragma unroll
    for (int lj = 1; lj >= 0; --lj) {
        const int js = 1 << lj;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j & js) continue;
            const u64 a = c[j], b = c[j + js];
            if (a < b) { c[j] = b; c[j + js] = a; }
        }
    }
#pragma unroll
    for (int lt = 4; lt >= 0; --lt) {
        const int st = 1 << lt;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            c[j] = exchange(c[j], st, (lane & st) == 0);
    }
    if (!last) {
#pragma unroll
        for (int j = 0; j < 4; ++j) lb[(size_t)r * KP + lane + 32 * j] = c[j];
    }
    const int g = (k - 1) >> 5;
    const u64 t = __shfl_sync(0xffffffffu,
                              g == 0 ? c[0] : g == 1 ? c[1] : g == 2 ? c[2]
                                                                   : c[3],
                              (k - 1) & 31);
    __syncwarp();
    if (lane == 0) {
        thr_key[r] = t;
        thr[r] = t == 0ull ? NEG_INF : key_score(t);
        cnt[r] = 0;
        merged[r] = 1;
    }
    __syncwarp();
}

// Row r's merge on the smallest network that holds its buffer (32, 64 or
// 128 keys); the last one writes the row's k indices to out.
__device__ __noinline__ void merge_row(u64* __restrict__ lb,
                                       const u64* __restrict__ buf,
                                       u64* __restrict__ thr_key,
                                       float* __restrict__ thr,
                                       int* __restrict__ cnt,
                                       int* __restrict__ merged, int r, int k,
                                       int lane, bool last,
                                       long long* __restrict__ out) {
    u64 c[4];
    const int n = cnt[r];
    if (n <= 32)
        merge_g<1>(c, lb, buf, thr_key, thr, cnt, merged, r, k, lane, last);
    else if (n <= 64)
        merge_g<2>(c, lb, buf, thr_key, thr, cnt, merged, r, k, lane, last);
    else
        merge_g<4>(c, lb, buf, thr_key, thr, cnt, merged, r, k, lane, last);
    if (last) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (lane + 32 * j < k)
                out[lane + 32 * j] = (long long)(unsigned)(~(unsigned)c[j]);
    }
}

// xt: [B, C, npad] (x transposed, zero past n); nrm: [B, npad] (+inf past
// n); lists: [B, gridDim.x BM, KP] keys, the rows' lists (no set-up);
// idx: [B, n, k] int64.
template <int C, bool JOINT>
__global__ void __launch_bounds__(THREADS, 2)
knn_graph_kernel(const float* __restrict__ xt, const float* __restrict__ nrm,
                 u64* __restrict__ lists, long long* __restrict__ idx, int n,
                 int npad, int k) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* buf = reinterpret_cast<u64*>(smem);             // [BM][CAP]
    u64* thr_key = buf + BM * CAP;                       // [BM]
    float* qs = reinterpret_cast<float*>(thr_key + BM);  // [C][BM]
    float* xs = qs + C * BM;                             // [2][C][BN]
    float* xns = xs + 2 * C * BN;                        // [2][BN]
    float* thr = xns + 2 * BN;                           // [BM]
    int* cnt = reinterpret_cast<int*>(thr + BM);         // [BM]
    int* merged = cnt + BM;                              // [BM]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ty = tid >> 3, tx = tid & 7;
    const int row0 = blockIdx.x * BM;
    const size_t cloud = blockIdx.y;
    const float* xb = xt + cloud * C * (size_t)npad;
    const float* nb = nrm + cloud * (size_t)npad;
    u64* lb = lists + (cloud * gridDim.x * BM + row0) * (size_t)KP;

    auto load_tile = [&](int t, int s) {
        const int col0 = t * BN;
        for (int e = tid; e < (C + 1) * (BN / 4); e += THREADS) {
            const int c = e / (BN / 4), p = (e % (BN / 4)) * 4;
            if (c < C)
                cp16(xs + (s * C + c) * BN + p,
                     xb + (size_t)c * npad + col0 + p);
            else
                cp16(xns + s * BN + p, nb + col0 + p);
        }
    };

    for (int e = tid; e < C * (BM / 4); e += THREADS) {
        const int c = e / (BM / 4), p = (e % (BM / 4)) * 4;
        cp16(qs + c * BM + p, xb + (size_t)c * npad + row0 + p);
    }
    load_tile(0, 0);
    cp_commit();
    if (tid < BM) {
        // rows past n take nothing (no key beats ~0, a NaN's included), so
        // they never merge
        thr_key[tid] = row0 + tid < n ? 0ull : ~0ull;
        thr[tid] = row0 + tid < n ? NEG_INF : -NEG_INF;
        cnt[tid] = 0;
        merged[tid] = 0;
    }
    float qn[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) qn[i] = nb[row0 + ty * TM + i];
    // the thread's candidates of a tile: 4 tx.. and 32 + 4 tx..
    int cj[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) cj[j] = (j < 4 ? 0 : 32 - 4) + tx * 4 + j;
    // the rows' thresholds, refreshed after a merge
    float th[TM];
    u64 thk[TM];
    const int ntiles = npad / BN;
    bool stale = true;
    for (int t = 0; t < ntiles; ++t) {
        cp_wait_all();
        __syncthreads();  // tile t landed; every warp is done with tile t - 1
        if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
        cp_commit();
        const float* xk = xs + (t & 1) * C * BN;
        const float* xnk = xns + (t & 1) * BN;
        if (stale) {
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                th[i] = thr[ty * TM + i];
                thk[i] = thr_key[ty * TM + i];
            }
            stale = false;
        }

        float sc[TM][TN];
        if constexpr (!JOINT) {
            float acc[TM][TN];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 16
            for (int c = 0; c < C; ++c) {
                float av[TM], bv[TN];
                load_operands(av, bv, qs + c * BM + ty * TM,
                              xk + c * BN + tx * 4);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    sc[i][j] = __fsub_rn(
                        __fsub_rn(__fmul_rn(2.f, acc[i][j]), qn[i]),
                        xnk[cj[j]]);
        } else {
            float sp[TM][TN], sn[TM][TN];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) sp[i][j] = sn[i][j] = 0.f;
#pragma unroll
            for (int c = 0; c < 6; ++c) {
                float av[TM], bv[TN];
                load_operands(av, bv, qs + c * BM + ty * TM,
                              xk + c * BN + tx * 4);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        if (c < 3) sp[i][j] = fmaf(av[i], bv[j], sp[i][j]);
                        else sn[i][j] = fmaf(av[i], bv[j], sn[i][j]);
                    }
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const float dp = __fadd_rn(
                        __fsub_rn(qn[i], __fmul_rn(2.f, sp[i][j])),
                        xnk[cj[j]]);
                    const float dn = __fsub_rn(2.f, __fmul_rn(2.f, sn[i][j]));
                    sc[i][j] = -__fmul_rn(dp, __fadd_rn(1.f, dn));
                }
        }

        // a score not below its row's threshold (rare once the rows have
        // merged a few times; a NaN score, or a NaN threshold, is never
        // below) goes to the exact compare and the buffer, by the lanes
        // that hold one
        bool any = false;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            float m = sc[i][0];
#pragma unroll
            for (int j = 1; j < TN; ++j) m = max_nan(m, sc[i][j]);
            any |= !(m < th[i]);
        }
        if (any) {
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const int r = ty * TM + i;
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const int col = t * BN + cj[j];
                    if (!(sc[i][j] < th[i]) && col < n) {
                        const u64 key = make_key(sc[i][j], col);
                        if (key > thk[i]) {
                            const int p = atomicAdd(&cnt[r], 1);
                            buf[r * CAP + p] = key;
                        }
                    }
                }
            }
        }
        __syncwarp();
        // a row whose buffer could overflow on the next tile merges now
        unsigned full = __ballot_sync(
            0xffffffffu,
            lane < WARP_ROWS && cnt[warp * WARP_ROWS + lane] > CAP - BN);
        stale = full != 0;
        while (full) {
            const int r = warp * WARP_ROWS + __ffs(full) - 1;
            full &= full - 1;
            merge_row(lb, buf, thr_key, thr, cnt, merged, r, k, lane, false,
                      nullptr);
        }
    }

#pragma unroll 1
    for (int rr = 0; rr < WARP_ROWS; ++rr) {
        const int r = warp * WARP_ROWS + rr;
        if (row0 + r >= n) break;
        merge_row(lb, buf, thr_key, thr, cnt, merged, r, k, lane, true,
                  idx + (cloud * n + row0 + r) * (size_t)k);
    }
}

template <int C, bool JOINT>
int launch(const float* xt, const float* nrm, u64* lists, long long* idx,
           int batch, int n, int npad, int k, cudaStream_t s) {
    const size_t smem = sizeof(u64) * (BM * CAP + BM)
                        + sizeof(float) * (C * BM + 2 * C * BN + 2 * BN + BM)
                        + sizeof(int) * 2 * BM;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            knn_graph_kernel<C, JOINT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((n + BM - 1) / BM, batch);
    knn_graph_kernel<C, JOINT><<<grid, THREADS, smem, s>>>(xt, nrm, lists,
                                                           idx, n, npad, k);
    return (int)cudaGetLastError();
}

}  // namespace

// xt: [batch, c, npad] f32, x transposed and zero-padded to npad (a multiple
// of 64, at least n); nrm: [batch, npad] f32, the squared norms (of the
// points, joint), +inf past n; lists: [batch, ceil(n / 64) 64, 128] 8-byte
// words of scratch; idx: [batch, n, k] int64. c and joint pick the
// instance: (3, 0), (64, 0) or (6, 1). 1 <= k <= min(n, 128). Returns
// cudaGetLastError() after the launch.
extern "C" int knn_graph(const void* xt, const void* nrm, void* lists,
                         void* idx, int batch, int n, int npad, int c, int k,
                         int joint, void* stream) {
    if (batch <= 0 || batch > 65535 || n <= 0 || k <= 0 || k > KP || k > n
        || npad < n || npad % BN != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(xt);
    const float* nf = static_cast<const float*>(nrm);
    u64* lf = static_cast<u64*>(lists);
    long long* out = static_cast<long long*>(idx);
    if (joint && c == 6)
        return launch<6, true>(xf, nf, lf, out, batch, n, npad, k, s);
    if (!joint && c == 3)
        return launch<3, false>(xf, nf, lf, out, batch, n, npad, k, s);
    if (!joint && c == 64)
        return launch<64, false>(xf, nf, lf, out, batch, n, npad, k, s);
    return (int)cudaErrorInvalidValue;
}
