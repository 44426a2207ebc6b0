// K7: the batched symmetric 3x3 eigensolver, fixed cyclic Jacobi sweeps in
// one launch.
//
// Replaces no TPU kernel: the JAX package's `_jacobi_eigh3`
// (parsenet_tpu/ops/linalg.py) is fused by XLA. The port's plain version
// (ops/kernels.eigh3_plain) runs each rotation as a dozen separate
// launches (a clone and four indexed writes to build J, three bmm, atan2,
// cos, sin and the elementwise ops around them), 320 a call at 7 sweeps;
// every fit (ops/primitive_fits.py) and the slots' standardisation
// (ops/standardize.py) wait on the host for them. Here one thread owns
// one matrix and runs every rotation in registers.
//
// What it computes, for A [batch, 3, 3] f32 and `sweeps`, the plain
// version's arithmetic bit for bit on the card:
//   for each sweep, for (p, q) in (0, 1), (0, 2), (1, 2):
//     theta = 0.5 * atan2(2 a_pq, a_qq - a_pp)
//     c, s  = cos(theta), sin(theta)
//     J     = I with J_pp = J_qq = c, J_pq = s, J_qp = -s
//     A     = (J^T A) J,  V = V J            (V starts as I)
//   w = diag(A), sorted ascending and stable (a NaN last, equal values in
//   index order: torch.argsort(stable=True)'s order), V's columns in the
//   same order.
// All 9 entries of A are kept: a_pq is read from a product that need not be
// exactly symmetric. Each product entry is the full 3-term dot over k with
// J's zeros and ones included, as cuBLAS computes it (a zero times an inf
// gives the plain path's NaN): with torch 2.11 (CUDA 12.8) on an H100, a
// probe against torch.bmm and torch.mm (all 3 orders of k, each with and
// without fused multiply-adds, on 3,000 to 100,000 random matrices at
// batch counts 1 to 100,000, 2-d too) found one FMA chain from +0 over
// k = 0, 1, 2 (cuBLAS's sm80_xmma_gemm kernels) for every product but one:
// at batch 1 the untransposed products B J and V J go to gemmSN_NN_kernel,
// which rounds the k = 2 product on its own and adds it to the chain of
// k = 0, 1. J^T A, a transposed operand, takes the chain at every batch.
// The scalar steps are CUDA's math library (atan2f, cosf, sinf; no
// fast-math; the probe found torch's bits on 2^20 arguments each) and
// each rounding of the plain path is its own operation (__fmul_rn,
// __fsub_rn), so nvcc contracts nothing.
//
// Bound on this card: latency. A matrix takes 7 x 3 rotations of 3 x 27
// FMA, an atan2f, a cosf and a sinf; 50 matrices fill part of one block
// of one SM, so a call costs one thread's chain, the launch included,
// against the plain version's ~320 launches. A rotation's chain is
// 2 a_pq (beside a_qq - a_pp), atan2f, 0.5 theta, cosf (beside sinf), then
// 3 dependent FMAs into J^T A and 3 more into (J^T A) J: 8 FP latencies,
// an atan2f's and a cosf's or sinf's. `eigh3_probe` times those latencies
// with clock64, and chip_smoke.py puts sweeps x 3 chains at the probe's
// clock, plus the kernel's time at 0 sweeps (launch, loads, sort, stores),
// beside K7's time. 72 bytes in and 48 out a matrix.
//
// Design. One thread a matrix, 128 threads a block (a batch of up to 128
// in one block), A, V and J in registers (the loop over (p, q) unrolled so
// every index is a constant), the sweeps a runtime loop; batch 1 launches
// the instance with the small-N order. Loads and stores are 9 and 12
// floats a thread, strided by 36 bytes across the warp: a call moves a few
// kilobytes, so coalescing is not worth shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

// One entry of a 3x3 product as cuBLAS gives it on this card (the probe in
// the header): an FMA chain from +0 over k = 0, 1, 2 ...
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
    return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmaf_rn(a0, b0, 0.0f)));
}

// ... except a single product of untransposed operands (batch 1: the plain
// path's B J and V J), which cuBLAS sends to its small-N kernel
// (gemmSN_NN_kernel): k = 0, 1 as an FMA chain from +0, the k = 2 product
// rounded on its own, then their sum.
__device__ __forceinline__ float dot3_small_n(float a0, float b0, float a1,
                                              float b1, float a2, float b2) {
    return __fadd_rn(__fmaf_rn(a1, b1, __fmaf_rn(a0, b0, 0.0f)),
                     __fmul_rn(a2, b2));
}

template <bool SINGLE>
__device__ __forceinline__ float dot3_right(float a0, float b0, float a1,
                                            float b1, float a2, float b2) {
    return SINGLE ? dot3_small_n(a0, b0, a1, b1, a2, b2)
                  : dot3(a0, b0, a1, b1, a2, b2);
}

// torch.sort's ascending comparator with NaN handling: a NaN above every
// number; two NaNs, or -0 and +0, equal.
__device__ __forceinline__ bool less_nan_last(float a, float b) {
    return (isnan(b) && !isnan(a)) || a < b;
}

__device__ __forceinline__ void swap2(float& x, float& y, int& i, int& j) {
    const float t = x;
    x = y;
    y = t;
    const int u = i;
    i = j;
    j = u;
}

// row[i] with i in 0..2, by selects (no local-memory array)
__device__ __forceinline__ float column(const float (&row)[3], int i) {
    return i == 0 ? row[0] : (i == 1 ? row[1] : row[2]);
}

template <int P, int Q, bool SINGLE>
__device__ __forceinline__ void rotate(float (&a)[3][3], float (&v)[3][3]) {
    const float theta = __fmul_rn(
        0.5f, atan2f(__fmul_rn(2.0f, a[P][Q]), __fsub_rn(a[Q][Q], a[P][P])));
    const float c = cosf(theta);
    const float s = sinf(theta);
    float j[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                     {0.0f, 0.0f, 1.0f}};
    j[P][P] = c;
    j[Q][Q] = c;
    j[P][Q] = s;
    j[Q][P] = -s;
    float b[3][3];   // J^T A
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            b[i][k] = dot3(j[0][i], a[0][k], j[1][i], a[1][k],
                           j[2][i], a[2][k]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            a[i][k] = dot3_right<SINGLE>(b[i][0], j[0][k], b[i][1], j[1][k],
                                         b[i][2], j[2][k]);
    float u[3][3];   // V J
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            u[i][k] = dot3_right<SINGLE>(v[i][0], j[0][k], v[i][1], j[1][k],
                                         v[i][2], j[2][k]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            v[i][k] = u[i][k];
}

template <bool SINGLE>
__global__ void __launch_bounds__(THREADS)
eigh3_kernel(const float* __restrict__ A, float* __restrict__ w_out,
             float* __restrict__ v_out, int batch, int sweeps) {
    const int m = blockIdx.x * THREADS + threadIdx.x;
    if (m >= batch) return;
    const float* src = A + (size_t)m * 9;
    float a[3][3], v[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            a[i][k] = src[3 * i + k];
            v[i][k] = i == k ? 1.0f : 0.0f;
        }
#pragma unroll 1
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        rotate<0, 1, SINGLE>(a, v);
        rotate<0, 2, SINGLE>(a, v);
        rotate<1, 2, SINGLE>(a, v);
    }
    // stable insertion sort of the diagonal, values and indices together
    float d0 = a[0][0], d1 = a[1][1], d2 = a[2][2];
    int i0 = 0, i1 = 1, i2 = 2;
    if (less_nan_last(d1, d0)) { swap2(d0, d1, i0, i1); }
    if (less_nan_last(d2, d1)) {
        swap2(d1, d2, i1, i2);
        if (less_nan_last(d1, d0)) { swap2(d0, d1, i0, i1); }
    }
    float* w = w_out + (size_t)m * 3;
    float* V = v_out + (size_t)m * 9;
    w[0] = d0;
    w[1] = d1;
    w[2] = d2;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        V[3 * r + 0] = column(v[r], i0);
        V[3 * r + 1] = column(v[r], i1);
        V[3 * r + 2] = column(v[r], i2);
    }
}

// The latencies the bound is made of, timed by one thread with clock64:
// out[0] cycles for `iters` dependent FMAs, out[1] for `iters` dependent
// atan2f, out[2] for `iters` dependent cosf, out[3] for `iters` dependent
// sinf (each chain starts from the last one's value, so none runs ahead);
// out[4] the cycles and out[5] the globaltimer nanoseconds over all four,
// for the clock; out[6] the chains' end, so none is optimised away.
__global__ void probe_kernel(long long* out, int iters, float seed) {
    long long g0 = 0, g1 = 0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    const long long t0 = clock64();
    float x = seed;
    for (int i = 0; i < iters; ++i) x = __fmaf_rn(x, 0.999f, 0.001f);
    const long long t1 = clock64();
    for (int i = 0; i < iters; ++i) x = atan2f(x, 0.75f);
    const long long t2 = clock64();
    for (int i = 0; i < iters; ++i) x = cosf(x);
    const long long t3 = clock64();
    for (int i = 0; i < iters; ++i) x = sinf(x);
    const long long t4 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t4 - t0;
    out[5] = g1 - g0;
    out[6] = __float_as_int(x);
}

}  // namespace

// out: 7 int64 on the card (probe_kernel's); one thread, one block.
// Returns cudaGetLastError() after the launch.
extern "C" int eigh3_probe(void* out, int iters, void* stream) {
    if (iters <= 0) return (int)cudaErrorInvalidValue;
    probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(out), iters, 0.5f);
    return (int)cudaGetLastError();
}

// A: [batch, 3, 3] f32 contiguous; w: [batch, 3] and v: [batch, 3, 3] f32
// contiguous outputs; batch >= 1, sweeps >= 0. Returns cudaGetLastError()
// after the launch.
extern "C" int eigh3(const void* A, void* w, void* v, int batch, int sweeps,
                     void* stream) {
    if (batch <= 0 || sweeps < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* a = static_cast<const float*>(A);
    float* wf = static_cast<float*>(w);
    float* vf = static_cast<float*>(v);
    if (batch == 1)
        eigh3_kernel<true><<<1, THREADS, 0, s>>>(a, wf, vf, batch, sweeps);
    else
        eigh3_kernel<false><<<(batch + THREADS - 1) / THREADS, THREADS, 0,
                              s>>>(a, wf, vf, batch, sweeps);
    return (int)cudaGetLastError();
}
