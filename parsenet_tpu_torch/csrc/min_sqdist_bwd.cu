// K4: the backward of the differentiable minimum squared distance.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, min_sqdist_fused (custom
// VJP at :449-472; its forward reaches the pallas_call at :418, which K3
// ports; this is the backward _msf_bwd, :463-469).
//
// With idx the argmin that K3 returned for each query and g the incoming
// gradient of its distance d_i = |q_i - x_idx(i)|^2:
//   dq_i        = 2 (q_i - x_idx(i)) g_i
//   dx_idx(i)  -= dq_i            (a scatter-add over the queries)
// Batched over patches: q [B, N, 3], x [B, M, 3], idx and g [B, N]. A target
// no query picked gets 0; a masked target is never the argmin unless every
// target of its patch is masked, so masked targets get no gradient. The
// multiplications are rounded separately ((2 (q - x)) g, no FMA
// contraction), as the plain version computes them, so dq is bitwise the
// plain version's. dx is summed in a fixed order, ascending query index
// (dx_j = ((0 - dq_i1) - dq_i2) - ..., i1 < i2 < ...), so two runs give the
// same bits, and so does the plain version, which sums in the same order.
// A query whose dq is zero in all three components is left out of the sum:
// that changes no bit of dx (the sum starts at +0 and a subtraction reaches
// -0 only from -0), and it keeps the chains short where the incoming
// gradient is zero for most queries.
//
// Bound on this card: bytes. Per query it reads q, g and idx and writes dq
// (32 bytes, against 12 FLOP); each distinct argmin row of x is read once
// (12 bytes) and dx is written once (12 bytes per target). At the training
// shape (36 x 700 queries, 36 x 1,600 targets, at most 25,200 distinct
// argmins) that is at most 1.8 MB, about half a microsecond at 3.35 TB/s,
// so latency sets the time: the launch, and the chain of dependent memory
// round trips inside it. The design keeps both to one.
//
// Design: one launch, no memset, no global atomics. The grid is (patch,
// target chunk); a block of 1,024 threads owns up to CHUNK targets of its
// patch (x and the head of a chain per target in shared memory, 16 bytes a
// target, so the training shape's 1,600 targets are one chunk and one block
// a patch). Each thread first starts the loads of its first query (idx, g,
// q), then stages its share of the chunk's x and empties its share of the
// chain heads: the two sets of loads are in flight together, so the block
// waits for one round trip to device memory, not for idx and then x[idx].
// After a barrier, each query whose argmin lies in the chunk writes dq,
// keeps it in its entry (dq and the next query of the chain, 16 bytes) and
// pushes itself onto its target's chain with one shared-memory atomicExch
// (a native instruction, unlike a float add, which Hopper runs as a
// compare-and-swap loop). The push order varies from run to run; the sum
// does not: after a second barrier, the thread that owns a target walks
// its chain and takes the queries in ascending index order (a selection
// over the chain, L^2 loads for L queries: the chains are short, most hold
// one query or none), and writes dx once. The entries live in shared
// memory where the patch's queries fit beside the chunk (the training
// shape: 11 KB), else in the caller's workspace in device memory ([B, N]
// entries; each query is written by the one block whose chunk holds its
// argmin, and read back by the same block after the barrier). Each query's argmin lies in exactly
// one chunk, so every dq is written once; a patch wider than a chunk is
// more blocks on the grid.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int THREADS = 1024;
constexpr int CHUNK = 9216;  // targets per block: 147,456 bytes of x and heads
constexpr int STAGE = 8;     // x loads a thread keeps in flight
constexpr int SMEM_MAX = 232448;

struct Query {
    int j;
    float g, a, b, c;
};

__device__ __forceinline__ Query load_query(const float* __restrict__ q,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ g,
                                            int i, int m) {
    return {min(max(idx[i], 0), m - 1), g[i], q[3 * i], q[3 * i + 1],
            q[3 * i + 2]};
}

__global__ void __launch_bounds__(THREADS)
min_sqdist_bwd_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      const int* __restrict__ idx, const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ dx,
                      float4* entries_ws, int n, int m, int chunk,
                      int entries_in_smem) {
    // [n] entries (if in shared memory), then [cnt, 3] x, then [cnt] heads
    extern __shared__ float4 smem4[];
    const size_t patch = blockIdx.x;
    const int c0 = blockIdx.y * chunk;
    const int cnt = min(chunk, m - c0);
    float4* ent = entries_in_smem ? smem4 : entries_ws + patch * n;
    float* xs = reinterpret_cast<float*>(entries_in_smem ? smem4 + n : smem4);
    int* head = reinterpret_cast<int*>(xs + 3 * cnt);
    q += patch * n * 3;
    dq += patch * n * 3;
    idx += patch * n;
    g += patch * n;
    x += (patch * m + c0) * 3;
    dx += (patch * m + c0) * 3;
    int i = threadIdx.x;
    Query cur{};
    if (i < n) cur = load_query(q, idx, g, i, m);
    // STAGE loads in flight before their stores, so the staging costs one
    // round trip (the training shape's 4,800 floats are one pass)
    for (int e0 = threadIdx.x; e0 < 3 * cnt; e0 += STAGE * THREADS) {
        float v[STAGE];
#pragma unroll
        for (int k = 0; k < STAGE; ++k) {
            const int e = e0 + k * THREADS;
            v[k] = e < 3 * cnt ? x[e] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < STAGE; ++k) {
            const int e = e0 + k * THREADS;
            if (e < 3 * cnt) xs[e] = v[k];
        }
    }
    for (int e = threadIdx.x; e < cnt; e += THREADS) head[e] = -1;
    __syncthreads();
    for (; i < n; i += THREADS) {
        Query next{};
        if (i + THREADS < n) next = load_query(q, idx, g, i + THREADS, m);
        const int j = cur.j - c0;
        if (j >= 0 && j < cnt) {
            const float v[3] = {cur.a, cur.b, cur.c};
            float d[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                d[c] = __fmul_rn(
                    __fmul_rn(2.f, __fsub_rn(v[c], xs[3 * j + c])), cur.g);
                dq[3 * i + c] = d[c];
            }
            // a query whose dq is exactly zero (the e2e loss weighs the
            // points off a slot's GT segment by 0) joins no chain: dx
            // starts at +0, so subtracting a zero leaves its bits as they
            // are, and a chain holds only the queries that move its target
            if (d[0] != 0.f || d[1] != 0.f || d[2] != 0.f)
                ent[i] = make_float4(
                    d[0], d[1], d[2],
                    __int_as_float(atomicExch(head + j, i)));
        }
        cur = next;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += THREADS) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
        // the chain's queries in ascending index order: each pass takes
        // the smallest index above the last one taken
        for (int last = -1;;) {
            int best = INT_MAX;
            float4 eb = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int k = head[j]; k >= 0;) {
                const float4 e = ent[k];
                if (k > last && k < best) { best = k; eb = e; }
                k = __float_as_int(e.w);
            }
            if (best == INT_MAX) break;
            a0 = __fsub_rn(a0, eb.x);
            a1 = __fsub_rn(a1, eb.y);
            a2 = __fsub_rn(a2, eb.z);
            last = best;
        }
        dx[3 * j] = a0;
        dx[3 * j + 1] = a1;
        dx[3 * j + 2] = a2;
    }
}

}  // namespace

// q: [batch, n, 3], x: [batch, m, 3], g: [batch, n] f32 and idx: [batch, n]
// int32, contiguous; dq: [batch, n, 3], dx: [batch, m, 3] f32 outputs, both
// written in full. entries: a workspace of batch x n float4, used only when
// 16 (n + min(m, 9,216)) bytes exceed the 232,448 a block can have (else
// it may be null). One launch; returns cudaGetLastError() after it.
extern "C" int min_sqdist_bwd(const void* q, const void* x, const void* idx,
                              const void* g, void* dq, void* dx,
                              void* entries, int batch, int n, int m,
                              void* stream) {
    if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const int chunk = m < CHUNK ? m : CHUNK;
    const size_t per_chunk = 16 * (size_t)chunk;
    const int in_smem = per_chunk + 16 * (size_t)n <= (size_t)SMEM_MAX;
    if (!in_smem && entries == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = per_chunk + (in_smem ? 16 * (size_t)n : 0);
    if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            min_sqdist_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(batch, (m + chunk - 1) / chunk);
    min_sqdist_bwd_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const int*>(idx), static_cast<const float*>(g),
        static_cast<float*>(dq), static_cast<float*>(dx),
        static_cast<float4*>(entries), n, m, chunk, in_smem);
    return (int)cudaGetLastError();
}
