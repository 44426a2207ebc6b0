// K2: forward auction (first-price bids, escalating eps), one block per
// matrix, B matrices a launch. Two entries share one round function:
//   auction_assign: on prepared benefit matrices [B, n, n], writes
//     obj_of_person [B, n] (-1 for persons still unassigned at the cap);
//   lap_assign: the whole solve_lap on cost matrices [B, n, n]: the
//     benefit (prologue), the auction, and the rank fill of the persons left
//     unassigned (epilogue), writing a permutation col_of_row [B, n].
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, auction_assign_pallas (:324,
// pallas_call at :345, kernel body _make_auction_kernel :259-315), and with
// lap_assign the benefit and completion of parsenet_tpu/ops/hungarian.py's
// solve_lap around it.
//
// Each round, for every unassigned person i:
//   vals = benefit[i] - prices; a1 = first argmax, m1 = max;
//   m2 = max of vals with column a1 lowered by 2 |NEG|;
//   bid = (prices[a1] + (m1 - m2)) + eps.
// Each object takes the highest bid (first person on ties; a column with no
// bid keeps person 0 as its nominal winner), evicts its previous owner,
// awards the winner and raises its price to the bid. eps is multiplied by
// esc every esc_every rounds, for min(max_iter, 512) rounds at most. The
// same f32 operations as the plain version (kernels.auction_assign_plain,
// kernels.lap_benefit, kernels.complete_assignment), each rounded on its
// own (no contraction), so the assignment is bit-identical. Padding is made
// here from n: n_pad = max(8, ceil8(n)), padding entries -1e6, padding
// persons parked on their own padding object with +1.
//
// Bound on this card: latency. A 56 x 56 matrix is 12.5 KB and a round a
// few thousand flops, but the rounds are serial: a round needs every bid of
// the round before an object can choose, so at least one block-wide
// barrier, and each bid needs a reduction over its row, a dependent chain
// of warp steps (5 shuffle steps for 32 lanes). The least a call takes is
// rounds x (barrier + that chain); `auction_probe` below measures both with
// clock64 on the card, and chip_smoke.py sets them beside the kernel's time
// per round.
//
// Design, against that bound:
// - Rows in registers, reduced across lanes. One block of n_pad / 2 warps
//   per matrix; a lane holds columns lane and lane + 32 of its warp's two
//   persons' rows: the benefit never changes, so it is read (or, for
//   lap_assign, computed) once. m1 is one redux.sync max over
//   order-preserving integer keys of the values, a1 the lowest column
//   holding it (two ballots), m2 a second redux.sync: two hardware
//   reductions instead of two 5-step shuffle chains. A warp's two persons
//   bid together, step by step, so their reductions overlap.
// - One barrier a round. Each bid is a native shared-memory atomicMax of
//   its key on its object (the highest bid, whatever order the atomics
//   land in), and the bidder records its key and (round, object). After
//   the barrier every warp reads the objects' keys: its lanes' prices, the
//   eviction of its assigned persons (their object took a bid), and, for a
//   bidder, the winner among that object's bidders of the highest key: the
//   lowest person, from two ballots over the recorded bids. So the first
//   person wins ties, bit for bit as the plain version's argmax, with no
//   second barrier, no 64-bit atomic (Hopper runs one in shared memory as a
//   compare-and-swap loop, which serialises the many bidders that the SIOU
//   matrices put on one object) and no warp that resolves objects for the
//   others. A fast warp may bid in the next round while a slow one still
//   reads this round's, so the keys rotate over three buffers (warp 0
//   clears the one two rounds ahead) and the bid records over two.
// - The next bids start before the outcome is known. On stream a's SIOU
//   matrices the persons left after round 1 are near-identical rows that
//   all bid on one object, and one of them wins a round, so a bidder most
//   likely bids again: a warp that bid computes its next bids at the new
//   prices at once and runs the winner ballots between their reductions;
//   a warp that did not bid computes bids only for a person just evicted.
// - A round with no bid ends the loop (everyone was assigned: later rounds
//   change nothing).
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int MAXN = 64;     // largest padded size: two columns a lane
constexpr int PPW = 2;       // persons a warp
constexpr float PAD = -1e6f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_BID = INT_MIN;   // below the key of every float

// order-preserving key of a float (no NaN here): the integer order of the
// keys is the order of the floats, -0 below +0
__device__ __forceinline__ int key_of(float x) {
    const int i = __float_as_int(x);
    return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float value_of(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// the entry (p, c) of the padded benefit, from the real one (b, n x n)
__device__ __forceinline__ float padded(float b, int p, int c, int n) {
    if (p < n) return c < n ? b : PAD;
    return c == p ? PAD + 1.f : PAD;
}

// lap_benefit of row p at column c, x = cost[p][c], uniform: the row's span
// is <= tol: -(cost + tie * c) + (uniform and c == p ? beta : 0)
__device__ __forceinline__ float benefit_of(float x, int p, int c,
                                            bool uniform, float tie,
                                            float beta) {
    const float park = (uniform && c == p) ? beta : 0.f;
    return __fadd_rn(-__fadd_rn(x, __fmul_rn(tie, static_cast<float>(c))),
                     park);
}

// A warp's PPW persons' rows (columns c0 = lane and c0 + 32; -inf past
// n_pad) at the prices p0, p1 -> each one's object j and the key of its
// bid. The persons go through each step together, so their warp
// reductions overlap, and mid() runs between the first reduction and the
// rest, so that other warp work overlaps them too (ptxas keeps
// warp-collective instructions in source order). No value is -0 (the rows
// hold +0 for -0), so equal keys are equal values, and the plain version's
// argmax, which takes -0 == +0, picks the same column.
template <typename Mid>
__device__ __forceinline__ void bids(const float* r0, const float* r1,
                                     float p0, float p1, int c0, float eps,
                                     int* j, int* key, Mid mid) {
    float v0[PPW], v1[PPW];
    int top[PPW], sec[PPW];
    unsigned bal0[PPW], bal1[PPW];
#pragma unroll
    for (int k = 0; k < PPW; ++k) {
        v0[k] = __fsub_rn(r0[k], p0);
        v1[k] = __fsub_rn(r1[k], p1);
        top[k] = max(key_of(v0[k]), key_of(v1[k]));
    }
#pragma unroll
    for (int k = 0; k < PPW; ++k) top[k] = __reduce_max_sync(FULL, top[k]);
    mid();
#pragma unroll
    for (int k = 0; k < PPW; ++k) {
        bal0[k] = __ballot_sync(FULL, key_of(v0[k]) == top[k]);
        bal1[k] = __ballot_sync(FULL, key_of(v1[k]) == top[k]);
    }
#pragma unroll
    for (int k = 0; k < PPW; ++k) {
        j[k] = bal0[k] ? __ffs(bal0[k]) - 1 : 31 + __ffs(bal1[k]);
        const float w0 = c0 == j[k] ? __fsub_rn(v0[k], 2.f * 1e9f) : v0[k];
        const float w1 =
            c0 + 32 == j[k] ? __fsub_rn(v1[k], 2.f * 1e9f) : v1[k];
        sec[k] = max(key_of(w0), key_of(w1));
    }
#pragma unroll
    for (int k = 0; k < PPW; ++k) sec[k] = __reduce_max_sync(FULL, sec[k]);
#pragma unroll
    for (int k = 0; k < PPW; ++k) {
        const float pj =
            __shfl_sync(FULL, j[k] < 32 ? p0 : p1, j[k] & 31);
        key[k] = key_of(__fadd_rn(
            __fadd_rn(pj, __fsub_rn(value_of(top[k]), value_of(sec[k]))),
            eps));
    }
}

static_assert(PPW == 2, "a warp's two persons are its lanes 0 and 1");

template <bool FROM_COST>
__global__ void __launch_bounds__(1024)
auction_kernel(const float* __restrict__ in, int* __restrict__ out, int n,
               float eps0, int esc_every, float esc, int rounds, float tie,
               float beta, float uniform_tol) {
    __shared__ int best[3][MAXN];      // a round's highest bid key, or NO_BID
    __shared__ int bid_key[2][MAXN];   // each bidder's bid key, and
    __shared__ int bid_tag[2][MAXN];   // (round << 6) | object
    __shared__ int obj_s[MAXN];
    __shared__ int free_col[MAXN];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_pad = max(8, (n + 7) & ~7);
    const int c0 = lane, c1 = lane + 32;
    const float* mat = in + static_cast<size_t>(blockIdx.x) * n * n;
    const float NEG_INF = __int_as_float(0xff800000);

    for (int t = threadIdx.x; t < 3 * MAXN; t += blockDim.x) {
        best[t / MAXN][t % MAXN] = NO_BID;
        if (t < 2 * MAXN) bid_tag[t / MAXN][t % MAXN] = -1;
    }

    // this warp's persons: rows in registers, -0 as +0, -inf past n_pad
    float r0[PPW], r1[PPW];
    int obj[PPW];   // warp-uniform: each person's object, or -1
#pragma unroll
    for (int k = 0; k < PPW; ++k) {
        const int p = warp * PPW + k;
        const float x0 = (p < n && c0 < n) ? mat[p * n + c0] : 0.f;
        const float x1 = (p < n && c1 < n) ? mat[p * n + c1] : 0.f;
        float b0 = x0, b1 = x1;
        if (FROM_COST) {
            // the row span over the n real columns, as max - min
            const int hi = __reduce_max_sync(
                FULL, max(c0 < n ? key_of(x0) : NO_BID,
                          c1 < n ? key_of(x1) : NO_BID));
            const int lo = __reduce_min_sync(
                FULL, min(c0 < n ? key_of(x0) : INT_MAX,
                          c1 < n ? key_of(x1) : INT_MAX));
            const bool uniform =
                __fsub_rn(value_of(hi), value_of(lo)) <= uniform_tol;
            b0 = benefit_of(x0, p, c0, uniform, tie, beta);
            b1 = benefit_of(x1, p, c1, uniform, tie, beta);
        }
        r0[k] = c0 < n_pad ? __fadd_rn(padded(b0, p, c0, n), 0.f) : NEG_INF;
        r1[k] = c1 < n_pad ? __fadd_rn(padded(b1, p, c1, n), 0.f) : NEG_INF;
        obj[k] = -1;
    }
    float pr0 = 0.f, pr1 = 0.f;   // the prices of columns c0, c1
    float eps = eps0;
    int to_esc = esc_every;
    int j[PPW], key[PPW];         // the next bids of the warp's persons
    const auto nothing = [] {};
    __syncthreads();
    bids(r0, r1, pr0, pr1, c0, eps, j, key, nothing);   // round 0

    for (int it = 0; it < rounds; ++it) {
        int* bst = best[it % 3];
        const int par = it & 1;
        const bool u0 = obj[0] < 0, u1 = obj[1] < 0;   // warp-uniform
        if (lane < PPW && (lane ? u1 : u0)) {
            const int jj = lane ? j[1] : j[0];
            const int kk = lane ? key[1] : key[0];
            atomicMax(&bst[jj], kk);
            bid_key[par][warp * PPW + lane] = kk;
            bid_tag[par][warp * PPW + lane] = it << 6 | jj;
        }
        __syncthreads();
        // the round's bids: prices, evictions, awards
        const int g0 = bst[c0], g1 = bst[c1];
        if (!__any_sync(FULL, g0 != NO_BID || g1 != NO_BID)) break;
        if (g0 != NO_BID) pr0 = value_of(g0);
        if (g1 != NO_BID) pr1 = value_of(g1);
        if (--to_esc == 0) {
            eps = __fmul_rn(eps, esc);
            to_esc = esc_every;
        }
        if (warp == 0) {   // clear the buffer of two rounds ahead
            best[(it + 2) % 3][c0] = NO_BID;
            best[(it + 2) % 3][c1] = NO_BID;
        }
        // each person's object (a bidder's: the one it bid on) and its key
        const int o0 = u0 ? j[0] : obj[0], o1 = u1 ? j[1] : obj[1];
        const int bo0 = __shfl_sync(FULL, o0 < 32 ? g0 : g1, o0 & 31);
        const int bo1 = __shfl_sync(FULL, o1 < 32 ? g0 : g1, o1 & 31);
        if (!(u0 || u1)) {   // no bidder here: evictions, then their bids
            if (bo0 != NO_BID) obj[0] = -1;
            if (bo1 != NO_BID) obj[1] = -1;
            if (obj[0] < 0 || obj[1] < 0)
                bids(r0, r1, pr0, pr1, c0, eps, j, key, nothing);
            continue;
        }
        // a warp that bid starts its next bids before it knows who won:
        // the winner of each bid's object, the lowest bidder of its highest
        // key, comes from two ballots over the round's bid records, run
        // between the next bids' reductions
        const int t0 = bid_tag[par][c0], t1 = bid_tag[par][c1];
        const int k0 = bid_key[par][c0], k1 = bid_key[par][c1];
        const int tag0 = it << 6 | o0, tag1 = it << 6 | o1;
        unsigned w0lo, w0hi, w1lo, w1hi;
        bids(r0, r1, pr0, pr1, c0, eps, j, key, [&] {
            w0lo = __ballot_sync(FULL, u0 && t0 == tag0 && k0 == bo0);
            w0hi = __ballot_sync(FULL, u0 && t1 == tag0 && k1 == bo0);
            w1lo = __ballot_sync(FULL, u1 && t0 == tag1 && k0 == bo1);
            w1hi = __ballot_sync(FULL, u1 && t1 == tag1 && k1 == bo1);
        });
        const int win0 = w0lo ? __ffs(w0lo) - 1 : 31 + __ffs(w0hi);
        const int win1 = w1lo ? __ffs(w1lo) - 1 : 31 + __ffs(w1hi);
        obj[0] = u0 ? (win0 == warp * PPW ? o0 : -1)
                    : (bo0 != NO_BID ? -1 : obj[0]);
        obj[1] = u1 ? (win1 == warp * PPW + 1 ? o1 : -1)
                    : (bo1 != NO_BID ? -1 : obj[1]);
    }

    if (lane == 0) {
        obj_s[warp * PPW] = obj[0];
        obj_s[warp * PPW + 1] = obj[1];
    }
    __syncthreads();
    int* o = out + static_cast<size_t>(blockIdx.x) * n;
    if (!FROM_COST) {
        for (int t = threadIdx.x; t < n; t += blockDim.x) o[t] = obj_s[t];
        return;
    }
    if (warp != 0) return;
    // the rank fill: the r-th unassigned person takes the r-th free column
    const int as0 = c0 < n ? obj_s[c0] : -2;
    const int as1 = c1 < n ? obj_s[c1] : -2;
    const unsigned taken_lo = __reduce_or_sync(
        FULL, (as0 >= 0 && as0 < 32 ? 1u << as0 : 0u)
                  | (as1 >= 0 && as1 < 32 ? 1u << as1 : 0u));
    const unsigned taken_hi = __reduce_or_sync(
        FULL, (as0 >= 32 && as0 < n ? 1u << (as0 - 32) : 0u)
                  | (as1 >= 32 && as1 < n ? 1u << (as1 - 32) : 0u));
    const unsigned below = (1u << lane) - 1u;
    const unsigned free_lo =
        __ballot_sync(FULL, c0 < n && !(taken_lo >> lane & 1u));
    const unsigned free_hi =
        __ballot_sync(FULL, c1 < n && !(taken_hi >> lane & 1u));
    if (free_lo >> lane & 1u) free_col[__popc(free_lo & below)] = c0;
    if (free_hi >> lane & 1u)
        free_col[__popc(free_lo) + __popc(free_hi & below)] = c1;
    __syncwarp();
    const int n_free = __popc(free_lo) + __popc(free_hi);
    const unsigned un_lo = __ballot_sync(FULL, as0 == -1);
    const unsigned un_hi = __ballot_sync(FULL, as1 == -1);
    if (c0 < n) {
        const int r = __popc(un_lo & below);
        o[c0] = as0 >= 0 ? as0 : (r < n_free ? free_col[r] : n);
    }
    if (c1 < n) {
        const int r = __popc(un_lo) + __popc(un_hi & below);
        o[c1] = as1 >= 0 ? as1 : (r < n_free ? free_col[r] : n);
    }
}

// The latencies the bound is made of, timed by thread 0 with clock64 in a
// block of `threads`: out[0] cycles for `iters` barriers (bar.sync, every
// warp), out[1] for `iters` dependent shuffle steps (shfl.bfly + fmax, warp
// 0 alone), out[2] for `iters` dependent redux.sync max (+ 1, warp 0
// alone); out[3] the cycles and out[4] the globaltimer nanoseconds over
// all three, for the clock.
__global__ void probe_kernel(long long* out, int iters) {
    long long g0 = 0, g1 = 0;
    __syncthreads();
    if (threadIdx.x == 0)
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) __syncthreads();
    const long long t1 = clock64();
    if (threadIdx.x >= 32) return;
    float x = static_cast<float>(threadIdx.x);
    for (int i = 0; i < iters; ++i)
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 1 << (i & 3)));
    const long long t2 = clock64();
    unsigned u = __float_as_uint(x);
    for (int i = 0; i < iters; ++i) u = __reduce_max_sync(FULL, u) + 1u;
    const long long t3 = clock64();
    if (threadIdx.x == 0) {
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
        out[0] = t1 - t0;
        out[1] = t2 - t1;
        out[2] = t3 - t2;
        out[3] = t3 - t0;
        out[4] = g1 - g0;
        out[5] = static_cast<long long>(u);   // keeps the chains live
    }
}

}  // namespace

namespace {

int launch(bool from_cost, const void* in, void* out, int batch, int n,
           float eps0, int esc_every, float esc, int rounds, float tie,
           float beta, float uniform_tol, void* stream) {
    if (batch <= 0 || n <= 0 || n > MAXN || esc_every <= 0 || rounds < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_pad = n < 8 ? 8 : (n + 7) / 8 * 8;
    const int threads = 32 * (n_pad / PPW);
    auto s = static_cast<cudaStream_t>(stream);
    auto i = static_cast<const float*>(in);
    auto o = static_cast<int*>(out);
    if (from_cost)
        auction_kernel<true><<<batch, threads, 0, s>>>(
            i, o, n, eps0, esc_every, esc, rounds, tie, beta, uniform_tol);
    else
        auction_kernel<false><<<batch, threads, 0, s>>>(
            i, o, n, eps0, esc_every, esc, rounds, 0.f, 0.f, 0.f);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// benefit: [batch, n, n] f32 contiguous; out: [batch, n] int32
// obj_of_person. Returns cudaGetLastError() after the launch.
extern "C" int auction_assign(const void* benefit, void* out, int batch,
                              int n, float eps0, int esc_every, float esc,
                              int rounds, void* stream) {
    return launch(false, benefit, out, batch, n, eps0, esc_every, esc, rounds,
                  0.f, 0.f, 0.f, stream);
}

// cost: [batch, n, n] f32 contiguous; out: [batch, n] int32 col_of_row, a
// permutation. tie, beta, uniform_tol: lap_benefit's constants.
extern "C" int lap_assign(const void* cost, void* out, int batch, int n,
                          float eps0, int esc_every, float esc, int rounds,
                          float tie, float beta, float uniform_tol,
                          void* stream) {
    return launch(true, cost, out, batch, n, eps0, esc_every, esc, rounds,
                  tie, beta, uniform_tol, stream);
}

// out: 6 int64 on the card (see probe_kernel). One block of `threads`.
extern "C" int auction_probe(void* out, int threads, int iters,
                             void* stream) {
    if (threads <= 0 || threads > 1024 || threads % 32 || iters <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(out), iters);
    return static_cast<int>(cudaGetLastError());
}
