// K3: per-query minimum squared distance to a masked target set, and its
// argmin.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, min_sqdist_with_idx_pallas
// (pallas_call at :418, kernel body _min_sqdist_kernel :377-404).
//
// Batched: q [B, N, 3] against x [B, M, 3], the TPU path getting the same by
// jax.vmap of the pallas_call. For each query q_i of patch b, its argmin is
// the first j that attains the minimum over patch b's targets of
// e_ij = w_j + (-2 x_j) . q_i, with w_j = |x_j|^2 + pen_j (pen_j = 0 for a
// kept target, 1e30 for a masked one, read from the mask itself), clipped
// to [0, M - 1]; its distance is then computed once, at that target, in the
// plain version's order of operations, ((|q|^2 - 2 q.x) + |x|^2) + pen, at
// most 1e30. So d rounds as the plain version's does, and only a near tie
// (within a few ulps of the operands' squared norms) can pick another
// index. The running minimum starts at 1e30 and falls only when strictly
// smaller, so the first index of the minimum wins and a patch whose targets
// are all masked gives 1e30 and index 0, as the TPU kernel's per-tile
// argmin and strict cross-tile update do. Exact f32 on the CUDA cores (the
// TPU kernel's HIGHEST-precision dot is an f32 product).
//
// Bound on this card: operations. 8 FP32 operations a pair (7.1e8 pairs a
// shape on the inference path, 4.0e7 a SplineNet training step) against 12
// to 16 bytes a point; in practice the dispatch rate of the instructions a
// pair costs, and which pipe they use: FFMA dispatches a warp a clock on
// each SM sub-partition, the compares and selects at half that. Tracking
// (min, argmin) per pair takes 3 FFMA, a compare and two selects: 6
// instructions, 3 of them at half rate. This kernel keeps only the running
// minimum per pair, 3 FFMA and one FMNMX, and the argmin per subtile of SUB
// targets: planned 4 + 2 / SUB + 1 / R (the shared load) = 4.4
// instructions a pair at R = 8; measured in the sm_90a SASS (`cuobjdump
// -sass`, which `chip_smoke.py` phase 2 reads): 4.58 at R = 8, 4.78 at R =
// 4, against 6 or more for a (min, argmin) per pair.
//
// Design: each thread holds R queries in registers (R = 4 or 8) and their
// running minima; the block stages its targets through shared memory as
// (-2x, -2y, -2z, w) (padded to whole subtiles with +inf), read by every
// thread as a broadcast and used R times. After each subtile a query whose
// minimum fell notes the subtile; at the end one rescan of that subtile,
// from device memory (through L1; lanes reading different targets from
// shared memory conflict on its banks, which measured slower) and with the
// same arithmetic (the same bits), finds the first target equal to the
// minimum. To fill the card whatever the
// shape, the targets of each patch are split into S chunks on the grid's y
// dimension (`kernels.min_sqdist_plan` picks R, the block size and S from a
// model of the busiest SM's time). With S = 1 the block writes the result;
// otherwise each block writes its chunk's (min, argmin) to a workspace, and
// a second launch merges the S partials of each query (four threads a
// query, a shuffle reduction that keeps the smaller value and, on a tie,
// the smaller index, since a chunk's indices lie below the next chunk's).
// Both launches happen in one call of the entry point.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int TILE = 512;  // targets staged in shared memory at a time
constexpr int SUB = 8;     // targets between two checks of the running min
constexpr int MERGE_LANES = 4;  // threads per query in the merge
constexpr int MERGE_THREADS = 256;
constexpr float BIG = 1e30f;

__device__ __forceinline__ float sq3(float a, float b, float c) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                     __fmul_rn(c, c));
}

// The squared distance of query (a, b, c) to target j in the plain
// version's order of operations, ((|q|^2 - 2 q.x_j) + |x_j|^2) + pen_j, at
// most 1e30 (the patch's x and mask).
__device__ __forceinline__ float plain_d(float a, float b, float c,
                                         const float* __restrict__ x,
                                         const float* __restrict__ mask,
                                         int j) {
    const float u = x[3 * (size_t)j], v = x[3 * (size_t)j + 1],
                w = x[3 * (size_t)j + 2];
    const float s = fmaf(c, w, fmaf(b, v, __fmul_rn(a, u)));
    float d = __fadd_rn(__fsub_rn(sq3(a, b, c), __fmul_rn(2.f, s)),
                        sq3(u, v, w));
    if (mask && !(mask[j] > 0.f)) d = __fadd_rn(d, BIG);
    return fminf(d, BIG);
}

// Target j as the scan uses it: (-2x, -2y, -2z, |x|^2 + pen); e of a query
// q is then fma(q.z, -2z, fma(q.y, -2y, fma(q.x, -2x, w))), the same bits
// wherever it is computed.
__device__ __forceinline__ float4 target_w(const float* __restrict__ x,
                                           const float* __restrict__ mask,
                                           int j) {
    const size_t k = 3 * (size_t)j;
    const float a = x[k], b = x[k + 1], c = x[k + 2];
    const float pen = (mask && !(mask[j] > 0.f)) ? BIG : 0.f;
    return make_float4(-2.f * a, -2.f * b, -2.f * c,
                       __fadd_rn(sq3(a, b, c), pen));
}

__device__ __forceinline__ float e_of(float a, float b, float c, float4 w) {
    return fmaf(c, w.z, fmaf(b, w.y, fmaf(a, w.x, w.w)));
}

// Query r of this thread: r * blockDim.x + threadIdx.x of the block's
// blockDim.x * R queries (coalesced loads for each r). The scan keeps only
// each query's running minimum (3 FFMA and one FMNMX a pair); after every
// SUB targets it notes, where the minimum dropped, the subtile's first
// index. At the end one rescan of that subtile, with the same arithmetic,
// finds the first target that attains the minimum.
template <int R>
__global__ void __launch_bounds__(MAX_THREADS)
min_sqdist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int* __restrict__ idx, float* __restrict__ part_e,
                  int* __restrict__ part_i, int n, int m, int chunk) {
    __shared__ float4 xs[TILE];
    const size_t patch = blockIdx.z;
    q += patch * n * 3;
    x += patch * m * 3;
    if (mask) mask += patch * m;
    const int base = blockIdx.x * blockDim.x * R + threadIdx.x;
    float q0[R], q1[R], q2[R], best[R];
    int sub[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = base + r * blockDim.x;
        q0[r] = q1[r] = q2[r] = 0.f;
        if (i < n) {
            q0[r] = q[3 * (size_t)i];
            q1[r] = q[3 * (size_t)i + 1];
            q2[r] = q[3 * (size_t)i + 2];
        }
        best[r] = BIG;
        sub[r] = -1;
    }
    const int c0 = blockIdx.y * chunk;
    const int c1 = min(m, c0 + chunk);
    for (int t0 = c0; t0 < c1; t0 += TILE) {
        const int cnt = min(TILE, c1 - t0);
        const int padded = (cnt + SUB - 1) / SUB * SUB;
        __syncthreads();  // every thread is done with the previous tile
        for (int e = threadIdx.x; e < padded; e += blockDim.x)
            xs[e] = e < cnt ? target_w(x, mask, t0 + e)
                            : make_float4(0.f, 0.f, 0.f,
                                          __int_as_float(0x7f800000));
        __syncthreads();
        for (int e0 = 0; e0 < padded; e0 += SUB) {
            float low[R];
#pragma unroll
            for (int r = 0; r < R; ++r) low[r] = best[r];
#pragma unroll
            for (int k = 0; k < SUB; ++k) {
                const float4 w = xs[e0 + k];
#pragma unroll
                for (int r = 0; r < R; ++r)
                    low[r] = fminf(low[r], e_of(q0[r], q1[r], q2[r], w));
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (low[r] < best[r]) sub[r] = t0 + e0;
                best[r] = low[r];
            }
        }
    }
    const size_t row = patch * n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = base + r * blockDim.x;
        if (i >= n) continue;
        int bi = 0;
        if (sub[r] >= 0) {
            const int hi = min(c1, sub[r] + SUB);
            for (int j = hi - 1; j >= sub[r]; --j)
                if (e_of(q0[r], q1[r], q2[r], target_w(x, mask, j)) == best[r])
                    bi = j;
        }
        if (gridDim.y == 1) {
            const int j = min(max(bi, 0), m - 1);
            out[row + i] = plain_d(q0[r], q1[r], q2[r], x, mask, j);
            idx[row + i] = j;
        } else {
            const size_t p = (blockIdx.y * (size_t)gridDim.z + patch) * n + i;
            part_e[p] = best[r];
            part_i[p] = bi;
        }
    }
}

// The S partials [S, total] of each of the total = B * N queries, merged in
// split order: MERGE_LANES threads a query, each over every MERGE_LANES-th
// split, then a shuffle reduction. A chunk's indices all lie below the next
// chunk's, so the smaller value, and on a tie the smaller index, is the
// first index of the minimum over the whole patch.
__global__ void __launch_bounds__(MERGE_THREADS)
min_sqdist_merge(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ mask,
                 const float* __restrict__ part_e,
                 const int* __restrict__ part_i, float* __restrict__ out,
                 int* __restrict__ idx, size_t total, int splits, int n,
                 int m) {
    const size_t t = ((size_t)blockIdx.x * MERGE_THREADS + threadIdx.x)
                     / MERGE_LANES;
    const int lane = threadIdx.x % MERGE_LANES;
    float best = BIG;
    int bi = 0;
    if (t < total) {
        for (int s = lane; s < splits; s += MERGE_LANES) {
            const float v = part_e[s * total + t];
            if (v < best) { best = v; bi = part_i[s * total + t]; }
        }
    }
#pragma unroll
    for (int o = 1; o < MERGE_LANES; o <<= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, best, o);
        const int j = __shfl_xor_sync(0xffffffffu, bi, o);
        if (v < best || (v == best && j < bi)) { best = v; bi = j; }
    }
    if (t < total && lane == 0) {
        const size_t patch = t / n;
        const int j = min(max(bi, 0), m - 1);
        out[t] = plain_d(q[3 * t], q[3 * t + 1], q[3 * t + 2],
                         x + patch * m * 3, mask ? mask + patch * m : mask, j);
        idx[t] = j;
    }
}

template <int R>
void launch(const dim3& grid, int threads, cudaStream_t s, const float* q,
            const float* x, const float* mask, float* out, int* idx,
            float* part_e, int* part_i, int n, int m, int chunk) {
    min_sqdist_kernel<R><<<grid, threads, 0, s>>>(q, x, mask, out, idx,
                                                 part_e, part_i, n, m, chunk);
}

}  // namespace

// q: [batch, n, 3], x: [batch, m, 3] f32 contiguous; mask: [batch, m] f32
// (> 0 keeps a target) or null; out: [batch, n] f32, idx: [batch, n] int32.
// r (4 or 8) queries a thread, threads a block (a multiple of 32, at most
// 256), splits target chunks a patch; with splits > 1, ws holds 2 * splits *
// batch * n 4-byte words for the partials and a second launch merges them.
// Returns cudaGetLastError() after the launches.
extern "C" int min_sqdist_idx(const void* q, const void* x, const void* mask,
                              void* out, void* idx, void* ws, int batch,
                              int n, int m, int r, int threads, int splits,
                              void* stream) {
    if (batch <= 0 || batch > 65535 || n <= 0 || m <= 0 || splits <= 0
        || splits > 65535 || threads <= 0 || threads > MAX_THREADS
        || threads % 32 != 0 || (r != 4 && r != 8) || (splits > 1 && !ws))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int chunk = (m + splits - 1) / splits;
    const dim3 grid((n + threads * r - 1) / (threads * r), splits, batch);
    const size_t total = (size_t)batch * n;
    float* part_e = static_cast<float*>(ws);
    int* part_i = static_cast<int*>(ws) + (splits > 1 ? splits * total : 0);
    const float* qf = static_cast<const float*>(q);
    const float* xf = static_cast<const float*>(x);
    const float* mf = static_cast<const float*>(mask);
    float* of = static_cast<float*>(out);
    int* ip = static_cast<int*>(idx);
    if (r == 8)
        launch<8>(grid, threads, s, qf, xf, mf, of, ip, part_e, part_i, n, m,
                  chunk);
    else
        launch<4>(grid, threads, s, qf, xf, mf, of, ip, part_e, part_i, n, m,
                  chunk);
    if (splits > 1) {
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const size_t blocks = (total * MERGE_LANES + MERGE_THREADS - 1)
                              / MERGE_THREADS;
        min_sqdist_merge<<<(unsigned)blocks, MERGE_THREADS, 0, s>>>(
            qf, xf, mf, part_e, part_i, of, ip, total, splits, n, m);
    }
    return (int)cudaGetLastError();
}
