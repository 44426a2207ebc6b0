// K3: per-query minimum squared distance to a masked target set, and its
// argmin.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, min_sqdist_with_idx_pallas
// (pallas_call at :418, kernel body _min_sqdist_kernel :377-404).
//
// Batched: q [B, N, 3] against x [B, M, 3], one launch, the batch on the
// grid's y dimension (the TPU path gets the same by jax.vmap of the
// pallas_call). For each query q_i of patch b: min_j (qq_i - 2 q_i . x_j)
// + (xx_j + pen_j) over patch b's targets, with pen_j = 0 for kept targets
// and 1e30 for masked ones (xx_j + pen_j is xx_j or 1e30 exactly, so this
// is the TPU kernel's ((qq - 2 q.x) + xx) + pen), and the first j that
// attains it. The running minimum starts at 1e30 with index 0 and takes a
// target only when strictly smaller, so the first index of the minimum
// wins, as the TPU kernel's per-tile argmin and strict cross-tile update
// do. Exact f32 on the CUDA cores.
//
// Bound on this card: operations, about 8 FP32 operations per pair
// (7.1e8 pairs per shape on the inference path, 4.0e7 per SplineNet
// training step), against 12-16 bytes per point.
//
// Design: one thread per query, its point and running (min, argmin) in
// registers; the targets (x, y, z, |x|^2 + pen) are staged through shared
// memory in tiles of 512, read by every thread of the block as broadcasts.
// Small blocks (64 threads) so 10k queries still spread over all SMs; each
// block offsets its pointers to its own patch. With so few warps per SM the
// global loads' latency is not hidden by other warps, so each thread loads
// its share of the next tile into registers before it scans the current
// one, and stores it after; the scan is unrolled by 8 so that each warp has
// shared loads and arithmetic of several targets in flight.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int TILE = 512;
constexpr int PER = TILE / THREADS;  // targets each thread stages per tile
constexpr float BIG = 1e30f;

__device__ __forceinline__ float sq3(float a, float b, float c) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                     __fmul_rn(c, c));
}

// This thread's share of the tile at t0: (x, y, z, pen) of targets
// t0 + threadIdx.x + r * THREADS that exist.
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          const float* __restrict__ pen,
                                          int t0, int m, float4 (&v)[PER]) {
#pragma unroll
    for (int r = 0; r < PER; ++r) {
        const int j = t0 + threadIdx.x + r * THREADS;
        if (j < m) {
            const size_t k = 3 * (size_t)j;
            v[r] = make_float4(x[k], x[k + 1], x[k + 2], pen[j]);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
min_sqdist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ pen, float* __restrict__ out,
                  int* __restrict__ idx, int n, int m) {
    __shared__ float4 xs[TILE];
    const size_t patch = blockIdx.y;
    q += patch * n * 3;
    x += patch * m * 3;
    pen += patch * m;
    out += patch * n;
    idx += patch * n;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    float q0 = 0.f, q1 = 0.f, q2 = 0.f;
    if (i < n) {
        q0 = q[3 * (size_t)i];
        q1 = q[3 * (size_t)i + 1];
        q2 = q[3 * (size_t)i + 2];
    }
    const float qq = sq3(q0, q1, q2);
    float best = BIG;
    int bi = 0;
    float4 v[PER];
    load_tile(x, pen, 0, m, v);
    for (int t0 = 0; t0 < m; t0 += TILE) {
        const int cnt = min(TILE, m - t0);
        __syncthreads();  // every thread is done with the previous tile
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int e = threadIdx.x + r * THREADS;
            if (e < cnt)
                xs[e] = make_float4(v[r].x, v[r].y, v[r].z,
                                    __fadd_rn(sq3(v[r].x, v[r].y, v[r].z),
                                              v[r].w));
        }
        __syncthreads();
        if (t0 + TILE < m) load_tile(x, pen, t0 + TILE, m, v);
#pragma unroll 8
        for (int e = 0; e < cnt; ++e) {
            const float4 p = xs[e];
            const float s = fmaf(q2, p.z, fmaf(q1, p.y, __fmul_rn(q0, p.x)));
            const float d = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, s)), p.w);
            if (d < best) { best = d; bi = t0 + e; }
        }
    }
    if (i < n) {
        out[i] = best;
        idx[i] = min(max(bi, 0), m - 1);
    }
}

}  // namespace

// q: [batch, n, 3], x: [batch, m, 3], pen: [batch, m] f32 contiguous; out:
// [batch, n] f32, idx: [batch, n] int32. Returns cudaGetLastError() after
// the launch.
extern "C" int min_sqdist_idx(const void* q, const void* x, const void* pen,
                              void* out, void* idx, int batch, int n, int m,
                              void* stream) {
    if (batch <= 0 || batch > 65535 || n <= 0 || m <= 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((n + THREADS - 1) / THREADS, batch);
    min_sqdist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const float*>(pen), static_cast<float*>(out),
        static_cast<int*>(idx), n, m);
    return (int)cudaGetLastError();
}
