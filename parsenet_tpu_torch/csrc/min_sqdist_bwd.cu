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
// contraction), as the plain version computes them.
//
// Bound on this card: bytes. Per query it reads q, g and idx and writes dq
// (32 bytes, against 12 FLOP); each distinct argmin row of x is read once
// (12 bytes) and dx is written once (12 bytes per target). At the training
// shape (36 x 700 queries, 36 x 1,600 targets, at most 25,200 distinct
// argmins) that is at most 1.8 MB, about half a microsecond at 3.35 TB/s,
// so the launch itself dominates.
//
// Design: one thread per (patch, query), flat over B * N. dx is zeroed with
// cudaMemsetAsync on the same stream before the launch, then each thread
// adds -dq into its argmin's row with float atomicAdd. Atomics make dx's sum
// order, and so its last bits, vary from run to run where several queries
// share an argmin; dq is exact.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
min_sqdist_bwd_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      const int* __restrict__ idx, const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ dx,
                      int batch, int n, int m) {
    const size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (t >= (size_t)batch * n) return;
    const size_t b = t / n;
    const int j = min(max(idx[t], 0), m - 1);
    const float* xj = x + (b * m + j) * 3;
    float* dxj = dx + (b * m + j) * 3;
    const float gg = g[t];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float d = __fmul_rn(__fmul_rn(2.f, __fsub_rn(q[3 * t + c], xj[c])),
                                  gg);
        dq[3 * t + c] = d;
        atomicAdd(dxj + c, -d);
    }
}

}  // namespace

// q: [batch, n, 3], x: [batch, m, 3], g: [batch, n] f32 and idx: [batch, n]
// int32, contiguous; dq: [batch, n, 3], dx: [batch, m, 3] f32 outputs (dx is
// zeroed here). Returns the first CUDA error of the memset or the launch.
extern "C" int min_sqdist_bwd(const void* q, const void* x, const void* idx,
                              const void* g, void* dq, void* dx, int batch,
                              int n, int m, void* stream) {
    if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(dx, 0, sizeof(float) * 3 * (size_t)batch
                                      * (size_t)m, s);
    if (err != cudaSuccess) return (int)err;
    const size_t total = (size_t)batch * n;
    const unsigned grid = (unsigned)((total + THREADS - 1) / THREADS);
    min_sqdist_bwd_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const int*>(idx), static_cast<const float*>(g),
        static_cast<float*>(dq), static_cast<float*>(dx), batch, n, m);
    return (int)cudaGetLastError();
}
