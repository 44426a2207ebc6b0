// K1: all mean-shift iterations of a row tile, with the tile kept on chip;
// and K5, one mean-shift step of separate queries, as a mode of the same
// kernel.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, mean_shift_iterations_pallas
// (pallas_call at :212, kernel body _make_ms_multi_kernel :107-182), and
// mean_shift_step_pallas (pallas_call at :83, kernel body _ms_step_kernel
// :27-57).
//
// Computes, for `iterations` steps with m0 = X (rows unit-norm, D = 128):
//   s = m . X^T,  K = exp((2 s - 2) * inv2b2)  (columns >= n masked to 0),
//   m <- normalize((K @ X) / (rowsum(K) + 1e-12)).
// With bf16 != 0 both operands of both products are rounded to bf16
// (round-to-nearest-even) and accumulated in f32, as the TPU kernel's
// bf16_dots does; the row sum always takes the unrounded f32 K.
//
// K5 (`ms_step`) is the same kernel with the query rows m0 [nq, D] apart
// from the keys X [nk, D], one iteration, f32 dots. It masks the key columns
// by the key count nk; the TPU kernel masks them by the query count (its
// only caller passes m = x, where the two agree).
//
// Bound on this card: operations. One iteration is two N x N x D products,
// 4 N^2 D FLOP (5.1e10 at N = 10,000), so 2.56e12 FLOP per 50-iteration
// call, against 5.1 MB of X that stays in the 50 MB L2. A K5 step is one
// such iteration, 4 Nq Nk D FLOP.
//
// Design: the TPU kernel keeps all of X in VMEM; a Hopper block has at most
// 227 KB of shared memory, so here one block owns a 64-row tile of m in
// shared memory for all iterations (it never returns to device memory
// between them) and streams X through shared memory in 64-row tiles. Per
// tile, phase A forms the 64 x 64 score tile with FFMA (4 x 4 outputs per
// thread), applies exp and the column mask and stores K in shared memory;
// phase B accumulates K @ X_tile into 4 x 8 register accumulators per
// thread. Row sums and row norms are reduced across the 16 lanes that share
// a row with warp shuffles. All arithmetic is FFMA on the CUDA cores; a
// tensor-core (wgmma) version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int D = 128;          // feature width the kernel takes
constexpr int TM = 64;          // rows of m owned by one block
constexpr int TN = 64;          // rows of X per streamed tile
constexpr int LD = D + 4;       // padded row stride of the m and X tiles
constexpr int LDK = TN + 4;     // padded row stride of the K tile
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = sizeof(float) * (TM * LD + TN * LD + TM * LDK);

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS, 2)
ms_iterations_kernel(const float* __restrict__ m0,
                     const float* __restrict__ x, float* __restrict__ out,
                     const float* __restrict__ inv2b2_ptr, int n_rows, int n,
                     int iterations, int bf16) {
    extern __shared__ float4 smem4[];
    float* ms = reinterpret_cast<float*>(smem4);   // [TM][LD]  m tile
    float* xs = ms + TM * LD;                      // [TN][LD]  X tile
    float* ks = xs + TN * LD;                      // [TM][LDK] K tile

    const int tid = threadIdx.x;
    const int tc = tid & 15;       // column group (16 lanes share a row)
    const int tr = tid >> 4;       // row group
    const int row0 = blockIdx.x * TM;
    const float inv2b2 = *inv2b2_ptr;

    for (int e = tid; e < TM * (D / 4); e += THREADS) {
        const int r = e / (D / 4), c4 = e % (D / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < n_rows)
            v = reinterpret_cast<const float4*>(m0 + (size_t)(row0 + r) * D)[c4];
        *reinterpret_cast<float4*>(ms + r * LD + c4 * 4) = v;
    }

    for (int it = 0; it < iterations; ++it) {
        __syncthreads();
        if (bf16) {
            // m is used only as the first product's operand this iteration
            for (int e = tid; e < TM * D; e += THREADS) {
                float* p = ms + (e / D) * LD + (e % D);
                *p = bf16_round(*p);
            }
            __syncthreads();
        }
        float acc[4][8];
        float rs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            rs[i] = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
        }

        for (int t0 = 0; t0 < n; t0 += TN) {
            for (int e = tid; e < TN * (D / 4); e += THREADS) {
                const int r = e / (D / 4), c4 = e % (D / 4);
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (t0 + r < n)
                    v = reinterpret_cast<const float4*>(
                        x + (size_t)(t0 + r) * D)[c4];
                if (bf16) {
                    v.x = bf16_round(v.x); v.y = bf16_round(v.y);
                    v.z = bf16_round(v.z); v.w = bf16_round(v.w);
                }
                *reinterpret_cast<float4*>(xs + r * LD + c4 * 4) = v;
            }
            __syncthreads();

            // phase A: s[i][j] = m[tr + 16 i] . X[t0 + tc + 16 j]
            float s[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
            for (int k = 0; k < D; k += 4) {
                float4 a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    a[i] = *reinterpret_cast<const float4*>(
                        ms + (tr + 16 * i) * LD + k);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    b[j] = *reinterpret_cast<const float4*>(
                        xs + (tc + 16 * j) * LD + k);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        float v = s[i][j];
                        v = fmaf(a[i].x, b[j].x, v);
                        v = fmaf(a[i].y, b[j].y, v);
                        v = fmaf(a[i].z, b[j].z, v);
                        v = fmaf(a[i].w, b[j].w, v);
                        s[i][j] = v;
                    }
            }
            float part[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                part[i] = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int col = t0 + tc + 16 * j;
                    const float kv = (col < n)
                        ? expf((2.f * s[i][j] - 2.f) * inv2b2) : 0.f;
                    part[i] += kv;
                    ks[(tr + 16 * i) * LDK + tc + 16 * j] =
                        bf16 ? bf16_round(kv) : kv;
                }
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
                rs[i] += part[i];
            }
            __syncthreads();

            // phase B: acc[i][h*4 + c] += sum_j K[tr + 16 i][j] X[j][64 h + 4 tc + c]
#pragma unroll 2
            for (int j = 0; j < TN; j += 4) {
                float4 kk[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    kk[i] = *reinterpret_cast<const float4*>(
                        ks + (tr + 16 * i) * LDK + j);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const float4 xa = *reinterpret_cast<const float4*>(
                        xs + (j + jj) * LD + tc * 4);
                    const float4 xb = *reinterpret_cast<const float4*>(
                        xs + (j + jj) * LD + 64 + tc * 4);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float kv = jj == 0 ? kk[i].x : jj == 1 ? kk[i].y
                                       : jj == 2 ? kk[i].z : kk[i].w;
                        acc[i][0] = fmaf(kv, xa.x, acc[i][0]);
                        acc[i][1] = fmaf(kv, xa.y, acc[i][1]);
                        acc[i][2] = fmaf(kv, xa.z, acc[i][2]);
                        acc[i][3] = fmaf(kv, xa.w, acc[i][3]);
                        acc[i][4] = fmaf(kv, xb.x, acc[i][4]);
                        acc[i][5] = fmaf(kv, xb.y, acc[i][5]);
                        acc[i][6] = fmaf(kv, xb.z, acc[i][6]);
                        acc[i][7] = fmaf(kv, xb.w, acc[i][7]);
                    }
                }
            }
            __syncthreads();
        }

        // new_m = acc / (rowsum + 1e-12); m = new_m / (|new_m| + 1e-12)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float den = rs[i] + 1e-12f;
            float ss = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                acc[i][c] = acc[i][c] / den;
                ss = fmaf(acc[i][c], acc[i][c], ss);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                ss += __shfl_xor_sync(0xffffffffu, ss, off);
            const float nrm = sqrtf(ss) + 1e-12f;
            float* row = ms + (tr + 16 * i) * LD;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    row[64 * h + 4 * tc + c] = acc[i][4 * h + c] / nrm;
        }
    }
    __syncthreads();
    for (int e = tid; e < TM * (D / 4); e += THREADS) {
        const int r = e / (D / 4), c4 = e % (D / 4);
        if (row0 + r < n_rows)
            reinterpret_cast<float4*>(out + (size_t)(row0 + r) * D)[c4] =
                *reinterpret_cast<const float4*>(ms + r * LD + c4 * 4);
    }
}

int launch(const void* m0, const void* x, void* out, const void* inv2b2,
           int n_rows, int n, int iterations, int bf16, void* stream) {
    if (n_rows <= 0 || n <= 0 || iterations < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ms_iterations_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int grid = (n_rows + TM - 1) / TM;
    ms_iterations_kernel<<<grid, THREADS, SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(m0), static_cast<const float*>(x),
        static_cast<float*>(out), static_cast<const float*>(inv2b2), n_rows,
        n, iterations, bf16);
    return (int)cudaGetLastError();
}

}  // namespace

// K1. x, out: [n, 128] f32 contiguous; inv2b2: one f32 on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int ms_iterations(const void* x, void* out, const void* inv2b2,
                             int n, int iterations, int bf16, void* stream) {
    return launch(x, x, out, inv2b2, n, n, iterations, bf16, stream);
}

// K5. m, out: [nq, 128], x: [nk, 128] f32 contiguous; inv2b2: one f32 on
// the device. One f32 step of every row of m against the keys x.
extern "C" int ms_step(const void* m, const void* x, void* out,
                       const void* inv2b2, int nq, int nk, void* stream) {
    return launch(m, x, out, inv2b2, nq, nk, 1, 0, stream);
}
