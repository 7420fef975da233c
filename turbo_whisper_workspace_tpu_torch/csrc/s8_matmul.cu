// W8A8 matmul (int8 activations with a per-row scale × int8 weights with
// a per-column scale) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel scripts/profile_llm_ops.py: s8_matmul (body
// _s8_kernel, pallas_call at :95), the LLM-ops profiler's s8×s8
// prototype. xq (M, K) int8, xs (M, 1) f32, wq (K, N) int8, ws (N,) f32:
//   out[m, n] = bf16((f32(Σ_k xq[m, k] · wq[k, n]) · xs[m]) · ws[n])
// The s32 sum is exact (|Σ| ≤ 127²·K < 2^31 up to K ≈ 133k), so its
// order does not matter and the kernel is bit-equal to its plain version.
//
// Design: two regimes behind one entry point; make_plan picks one from
// (M, K, N) and is mirrored by scripts/profile_llm_ops.py:s8_plan.
//
// M ≤ 16, the profiler's path (M = 1): a GEMV that reads every weight
// byte once for 2 operations, HBM-bound. The lm_head of llama-3.2-3b,
// 3072 × 128256 int8, is 394 MB → 0.118 ms at 3.35 TB/s; a 3072 × 8192
// projection 25 MB → 7.5 µs. The split-K GEMV of gemv_mma.cuh: a lane
// streams 16 columns × 8 rows a K step with 16-byte loads, transposes
// each 4 × 4 byte block with __byte_perm (int8_blocks.cuh) into the
// K-major words of mma.sync m16n8k32's A fragment (the weight's columns
// are A's rows), and x's rows are the B fragment (8 bytes of one row a
// lane and a step), one n8 tile for M ≤ 8, two for M ≤ 16. The products
// cost the same few byte permutes a weight byte at any M ≤ 16, where
// dp4a would cost M/4 instructions a byte more. K is split over a
// cluster where the column tiles do not fill the card; the exact s32
// partials meet in shared memory and then across the ranks (any order
// is exact), and the two scales are applied once.
//
// M > 16: the first design, kept. mma.sync m16n8k32 on 16-row tiles of
// M: one block of 8 warps takes 32 columns (four n8 tiles) and a 16-row
// tile; the warps split K in k32 steps; each lane reads two 4x4 byte
// blocks of W straight from global memory and transposes them, the
// tiles' columns permuted so that no byte goes through shared memory
// (int8_blocks.cuh); the 8 warps' sums meet through shared integer
// atomics. Ragged N and K are masked in both kernels: no padded copy of W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemv_mma.cuh"
#include "int8_blocks.cuh"

namespace {

constexpr int BN = 32;               // columns per block: four n8 tiles
constexpr int BM = 16;               // rows of M per block: the mma's M
constexpr int WARPS = 8;             // split K
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
s8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
              const int8_t* __restrict__ w, const float* __restrict__ ws,
              __nv_bfloat16* __restrict__ out, int m, int k, int n) {
    __shared__ int sums[BM][BN];

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;

    for (int i = tid; i < BM * BN; i += THREADS) sums[i / BN][i % BN] = 0;

    int c[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0;
#pragma unroll 2
    for (int k0 = warp * 32; k0 < k; k0 += WARPS * 32) {
        unsigned a[4], b[4][2];
        load_a(xq, m, k, m0, k0, g, t, a);
        load_b(w, k, n, n0, k0, g, t, b);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(c[j], a, b[j][0], b[j][1]);
    }
    __syncthreads();                     // sums are zeroed
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e / 2);
            if (m0 + r < m) atomicAdd(&sums[r][acc_column(j, e, t)], c[j][e]);
        }
    __syncthreads();

    for (int i = tid; i < BM * BN; i += THREADS) {
        const int row = m0 + i / BN;
        const int col = n0 + i % BN;
        if (row < m && col < n)
            out[(long long)row * n + col] = __float2bfloat16(
                __fmul_rn(__fmul_rn((float)sums[i / BN][i % BN], xs[row]), ws[col]));
    }
}


constexpr int GEMV_MAX_M = 16;           // rows of the GEMV regime: two n8 tiles of x
constexpr int GEMV_STEP = 32;            // K rows a warp's step: the mma's depth

// mirrored by scripts/profile_llm_ops.py:s8_plan: the regime (1: the
// GEMV, 0: the 16-row mma tiles) and the GEMV's K split (cluster size)
struct Plan {
    int gemv, split;
};

Plan make_plan(int m, int k, int n) {
    if (m <= GEMV_MAX_M) return {1, gemv_split((k + GEMV_STEP - 1) / GEMV_STEP, n)};
    return {0, 1};
}

// Lane (g, t) of a step at row k0 holds the weight rows k0 + 8t + i
// (i < 8) of its 16 columns; the mma's depth index 4t .. 4t + 3 stands
// for rows k0 + 8t .. + 3 and 16 + 4t .. for rows k0 + 8t + 4 .. + 7, so
// x's B fragment is the 8 bytes at xq[row, k0 + 8t ..] (two words).
template <int NT, bool WIDE>
__global__ void __launch_bounds__(GEMV_THREADS)
s8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
               const int8_t* __restrict__ w, const float* __restrict__ ws,
               __nv_bfloat16* __restrict__ out, int m, int k, int n) {
    extern __shared__ int red[];             // GEMV_WARPS × 8·NT × GEMV_COLS
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const GemvSlice slice = gemv_slice((k + GEMV_STEP - 1) / GEMV_STEP);
    const int col = slice.n0 + 16 * g;

    int acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0;

    for (int step = slice.begin + warp; step < slice.end; step += GEMV_WARPS) {
        const int r0 = step * GEMV_STEP + 8 * t;
        uint4 wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) wv[i] = gemv_row16<WIDE>(w, r0 + i, col, k, n);
        unsigned b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int row = 8 * nt + g;
            const int8_t* p = xq + (size_t)row * k + r0;
            b[nt][0] = load4(p, row < m && r0 < k);
            b[nt][1] = load4(p + 4, row < m && r0 + 4 < k);
        }
        unsigned a[8][4];
        gemv_fragments(wv, a);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_s8(acc[nt][j], a[j], b[nt][0], b[nt][1]);
    }
    gemv_fold<NT>(acc, red, m, slice.n0, n, [&](int row, int c, int sum) {
        out[(size_t)row * n + c] =
            __float2bfloat16(__fmul_rn(__fmul_rn((float)sum, xs[row]), ws[c]));
    });
}

}  // namespace

template <int NT>
cudaError_t launch_gemv(bool wide, int split, cudaStream_t st, const int8_t* xq, const float* xs,
                        const int8_t* w, const float* ws, __nv_bfloat16* out, int m, int k,
                        int n) {
    const int smem = GEMV_WARPS * 8 * NT * GEMV_COLS * (int)sizeof(int);
    return wide ? gemv_launch(s8_gemv_kernel<NT, true>, n, split, smem, st, xq, xs, w, ws, out,
                              m, k, n)
                : gemv_launch(s8_gemv_kernel<NT, false>, n, split, smem, st, xq, xs, w, ws, out,
                              m, k, n);
}

// xq (m, k) int8, xs (m, 1) f32, w (k, n) int8, ws (n,) f32, out (m, n)
// bf16; all dense, k and n multiples of 4. Returns the launch's error,
// or cudaGetLastError() after it.
extern "C" int tww_s8_matmul(const void* xq, const void* xs, const void* w, const void* ws,
                             void* out, int m, int k, int n, void* stream) {
    const Plan p = make_plan(m, k, n);
    const auto xq8 = static_cast<const int8_t*>(xq);
    const auto xsf = static_cast<const float*>(xs);
    const auto w8 = static_cast<const int8_t*>(w);
    const auto wsf = static_cast<const float*>(ws);
    const auto ob = static_cast<__nv_bfloat16*>(out);
    const cudaStream_t st = (cudaStream_t)stream;
    if (p.gemv) {
        const bool wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
        const cudaError_t err =
            m <= 8 ? launch_gemv<1>(wide, p.split, st, xq8, xsf, w8, wsf, ob, m, k, n)
                   : launch_gemv<2>(wide, p.split, st, xq8, xsf, w8, wsf, ob, m, k, n);
        if (err != cudaSuccess) return (int)err;
    } else {
        const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
        s8_mma_kernel<<<grid, THREADS, 0, st>>>(xq8, xsf, w8, wsf, ob, m, k, n);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* tww_s8_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
