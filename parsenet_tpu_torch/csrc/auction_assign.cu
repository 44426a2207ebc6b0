// K2: forward auction (first-price bids, escalating eps) on a prepared
// benefit matrix, one block per matrix.
//
// Replaces: parsenet_tpu/ops/pallas_kernels.py, auction_assign_pallas
// (pallas_call at :345, kernel body _make_auction_kernel :259-315).
//
// Each round, for every unassigned person i:
//   vals = benefit[i] - prices; a1 = first argmax, m1 = max;
//   m2 = max of vals with column a1 lowered by 2 |NEG|;
//   bid = (prices[a1] + (m1 - m2)) + eps.
// Each object takes the highest bid (first person on ties; a column with no
// bid keeps person 0 as its nominal winner), evicts its previous owner,
// awards the winner and raises its price to the bid. eps is multiplied by
// esc every esc_every rounds. The same f32 operations in the same order as
// the TPU kernel, so the assignment is bit-identical. Returns obj_of_person,
// -1 for persons still unassigned after `rounds`.
//
// Bound on this card: latency. A 56 x 56 matrix is 12.5 KB and a round is a
// few thousand flops, but rounds are serial: one launch plus up to 512
// dependent rounds of a few barriers each.
//
// Design: benefit, prices, bids and the assignment live in shared memory;
// one thread per person for the row scans, then one thread per object for
// the column scans, with a barrier between the phases. Once every person is
// assigned no one bids and a round changes nothing, so the block leaves the
// loop then (a block-wide vote); the result is the same as running all
// `rounds`.
#include <cuda_runtime.h>

namespace {

constexpr int MAXN = 64;
constexpr float NEG = -1e9f;

__global__ void auction_kernel(const float* __restrict__ benefit,
                               int* __restrict__ out, int n, float eps0,
                               int esc_every, float esc, int rounds) {
    __shared__ float B[MAXN * MAXN];
    __shared__ float prices[MAXN], bid[MAXN], obj_best[MAXN];
    __shared__ int obj[MAXN], a1s[MAXN], winner[MAXN];

    const int t = threadIdx.x;
    const float* b = benefit + (size_t)blockIdx.x * n * n;
    for (int e = t; e < n * n; e += blockDim.x) B[e] = b[e];
    if (t < n) {
        obj[t] = -1;
        prices[t] = 0.f;
    }
    float eps = eps0;

    for (int it = 0; it < rounds; ++it) {
        if (!__syncthreads_or(t < n && obj[t] < 0)) break;
        // persons: best and second-best object at current prices
        if (t < n) {
            const float* row = B + t * n;
            float m1 = row[0] - prices[0];
            int a1 = 0;
            for (int j = 1; j < n; ++j) {
                const float v = row[j] - prices[j];
                if (v > m1) { m1 = v; a1 = j; }
            }
            float m2 = -3.402823466e38f;
            for (int j = 0; j < n; ++j) {
                float v = row[j] - prices[j];
                if (j == a1) v = v - 2.f * 1e9f;
                m2 = fmaxf(m2, v);
            }
            const float gap = m1 - m2;
            const float raised = prices[a1] + gap;
            bid[t] = obj[t] < 0 ? raised + eps : NEG;
            a1s[t] = a1;
        }
        __syncthreads();
        // objects: highest bid, first person on ties
        if (t < n) {
            float best = a1s[0] == t ? bid[0] : NEG;
            int w = 0;
            for (int i = 1; i < n; ++i) {
                const float v = a1s[i] == t ? bid[i] : NEG;
                if (v > best) { best = v; w = i; }
            }
            obj_best[t] = best;
            winner[t] = w;
        }
        __syncthreads();
        // evict, award, reprice
        if (t < n) {
            int o = obj[t];
            const bool unas = o < 0;
            if (o >= 0 && obj_best[o] > NEG / 2 && winner[o] != t) o = -1;
            if (unas && winner[a1s[t]] == t) o = a1s[t];
            obj[t] = o;
            if (obj_best[t] > NEG / 2) prices[t] = obj_best[t];
        }
        if ((it + 1) % esc_every == 0) eps = eps * esc;
    }
    __syncthreads();
    if (t < n) out[(size_t)blockIdx.x * n + t] = obj[t];
}

}  // namespace

// benefit: [batch, n, n] f32 contiguous; out: [batch, n] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int auction_assign(const void* benefit, void* out, int batch,
                              int n, float eps0, int esc_every, float esc,
                              int rounds, void* stream) {
    if (batch <= 0 || n <= 0 || n > MAXN || esc_every <= 0 || rounds < 0)
        return (int)cudaErrorInvalidValue;
    const int threads = ((n + 31) / 32) * 32;
    auction_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(benefit), static_cast<int*>(out), n, eps0,
        esc_every, esc, rounds);
    return (int)cudaGetLastError();
}
