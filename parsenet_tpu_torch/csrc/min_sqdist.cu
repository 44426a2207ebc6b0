// K3: per-query minimum squared distance to a masked target set, and its
// argmin.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, min_sqdist_with_idx_pallas
// (pallas_call at :418, kernel body _min_sqdist_kernel :377-404).
//
// For each query q_i: min_j ((qq_i - 2 q_i . x_j) + xx_j) + pen_j, with
// pen_j = 0 for kept targets and 1e30 for masked ones, and the first j that
// attains it. The running minimum starts at 1e30 with index 0 and takes a
// target only when strictly smaller, so the first index of the minimum
// wins, as the TPU kernel's per-tile argmin and strict cross-tile update
// do. Exact f32 on the CUDA cores.
//
// Bound on this card: operations, about 8 FP32 operations per pair
// (7.1e8 pairs per shape on the main path), against 12-16 bytes per point.
//
// Design: one thread per query, its point and running (min, argmin) in
// registers; the targets (x, y, z, |x|^2) and their penalties are staged
// through shared memory in tiles of 512, read by every thread of the block
// as broadcasts. Small blocks (64 threads) so 10k queries still spread over
// all SMs.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int TILE = 512;
constexpr float BIG = 1e30f;

__device__ __forceinline__ float sq3(float a, float b, float c) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                     __fmul_rn(c, c));
}

__global__ void __launch_bounds__(THREADS)
min_sqdist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ pen, float* __restrict__ out,
                  int* __restrict__ idx, int n, int m) {
    __shared__ float4 xs[TILE];
    __shared__ float ps[TILE];
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
    for (int t0 = 0; t0 < m; t0 += TILE) {
        const int cnt = min(TILE, m - t0);
        for (int e = threadIdx.x; e < cnt; e += THREADS) {
            const size_t j = (size_t)(t0 + e);
            const float a = x[3 * j], b = x[3 * j + 1], c = x[3 * j + 2];
            xs[e] = make_float4(a, b, c, sq3(a, b, c));
            ps[e] = pen[j];
        }
        __syncthreads();
        for (int e = 0; e < cnt; ++e) {
            const float4 p = xs[e];
            const float s = fmaf(q2, p.z, fmaf(q1, p.y, __fmul_rn(q0, p.x)));
            const float d = __fadd_rn(
                __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, s)), p.w), ps[e]);
            if (d < best) { best = d; bi = t0 + e; }
        }
        __syncthreads();
    }
    if (i < n) {
        out[i] = best;
        idx[i] = min(max(bi, 0), m - 1);
    }
}

}  // namespace

// q: [n, 3], x: [m, 3], pen: [m] f32 contiguous; out: [n] f32, idx: [n]
// int32. Returns cudaGetLastError() after the launch.
extern "C" int min_sqdist_idx(const void* q, const void* x, const void* pen,
                              void* out, void* idx, int n, int m,
                              void* stream) {
    if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const int grid = (n + THREADS - 1) / THREADS;
    min_sqdist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const float*>(pen), static_cast<float*>(out),
        static_cast<int*>(idx), n, m);
    return (int)cudaGetLastError();
}
