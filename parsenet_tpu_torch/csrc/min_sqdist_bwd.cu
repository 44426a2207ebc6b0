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
// plain version's.
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
// patch (x and dx of the chunk in shared memory, 24 bytes a target, so the
// training shape's 1,600 targets are one chunk and one block a patch). Each
// thread first starts the loads of its first query (idx, g, q), then
// stages its share of the chunk's x and zeroes its share of dx: the two
// sets of loads are in flight together, so the block waits for one round
// trip to device memory, not for idx and then x[idx]. After a barrier,
// each query whose argmin lies in the chunk writes dq and adds -dq into
// the chunk with shared-memory atomics (the next query's loads start
// first, where a thread has more than one); after a second barrier the
// block writes its dx chunk once, coalesced. Each query's argmin lies in
// exactly one chunk, so every dq is written once; a patch wider than a
// chunk is more blocks on the grid. The shared atomics make dx's sum order,
// and so its last bits, vary from run to run where several queries share
// an argmin. Hopper has no shared-memory float add: atomicAdd compiles to
// a compare-and-swap loop. On an H100 at the training shape the kernel
// takes 3.9 us of device time, 1.1 us of it an empty launch's; staging x
// and writing dx alone take 2.5 us, the CAS loops 0.8. Tried and slower:
// 256 or 512 threads, warp-aggregated atomics, the three CAS loops of a
// query interleaved, patches split over more SMs.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int CHUNK = 9216;  // targets per block: 221,184 bytes of x and dx
constexpr int STAGE = 8;     // x loads a thread keeps in flight

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
                      float* __restrict__ dq, float* __restrict__ dx, int n,
                      int m, int chunk) {
    extern __shared__ float smem[];  // [cnt, 3] x, then [cnt, 3] dx
    const size_t patch = blockIdx.x;
    const int c0 = blockIdx.y * chunk;
    const int cnt = min(chunk, m - c0);
    float* xs = smem;
    float* acc = smem + 3 * cnt;
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
            if (e < 3 * cnt) {
                xs[e] = v[k];
                acc[e] = 0.f;
            }
        }
    }
    __syncthreads();
    for (; i < n; i += THREADS) {
        Query next{};
        if (i + THREADS < n) next = load_query(q, idx, g, i + THREADS, m);
        const int j = cur.j - c0;
        if (j >= 0 && j < cnt) {
            const float v[3] = {cur.a, cur.b, cur.c};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float d = __fmul_rn(
                    __fmul_rn(2.f, __fsub_rn(v[c], xs[3 * j + c])), cur.g);
                dq[3 * i + c] = d;
                atomicAdd(acc + 3 * j + c, -d);
            }
        }
        cur = next;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * cnt; e += THREADS) dx[e] = acc[e];
}

}  // namespace

// q: [batch, n, 3], x: [batch, m, 3], g: [batch, n] f32 and idx: [batch, n]
// int32, contiguous; dq: [batch, n, 3], dx: [batch, m, 3] f32 outputs, both
// written in full. One launch; returns cudaGetLastError() after it.
extern "C" int min_sqdist_bwd(const void* q, const void* x, const void* idx,
                              const void* g, void* dq, void* dx, int batch,
                              int n, int m, void* stream) {
    if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const int chunk = m < CHUNK ? m : CHUNK;
    const size_t smem = sizeof(float) * 6 * chunk;
    if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            min_sqdist_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(sizeof(float) * 6 * CHUNK));
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(batch, (m + chunk - 1) / chunk);
    min_sqdist_bwd_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const int*>(idx), static_cast<const float*>(g),
        static_cast<float*>(dq), static_cast<float*>(dx), n, m, chunk);
    return (int)cudaGetLastError();
}
