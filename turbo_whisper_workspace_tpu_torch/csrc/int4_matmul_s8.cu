// W4A8 matmul (int8 activations × grouped int4 weights) for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/quant.py:
// int4_matmul_s8 (body _s8g4_kernel, pallas_call at :275). xq (M, K) int8
// with per-(row, group) scales xs (M, n_groups) f32; the weight packed as
// for int4_matmul: (K/2, N) int8, low nibble row r, high nibble row
// r + K/2, sign-extended, scales ws (n_groups, N) f32. For each group g
// (G = K/n_groups rows) an exact s32 dot d_g = Σ xq·w, then, groups in
// order, acc = acc + d_g · (xs[m, g] · ws[g, n]) in f32; out bf16.
//
// What bounds it on the H100: on the LLM's path it is every body
// projection of every decode step, M = 1: a GEMV that reads every packed
// weight byte once, about 2 integer operations per byte. It is bound by
// HBM: at (K, N) = (4096, 14336), 29.4 MB of nibbles plus 1.8 MB of
// scales → 9.3 µs at 3.35 TB/s; one decode step's 224 projections read
// about 3.7 GB → 1.11 ms.
//
// Design: two passes in one call. Pass 1: one block per (128 columns,
// group pair, chunk of 8 rows of M); a group pair is the G packed rows
// whose low nibbles are group g and high nibbles group g + n_groups/2.
// Warp w of 8 takes the pair's packed rows w, w + 8, ...; lane l reads 4
// packed bytes at columns 4l..4l+3, so a warp reads 128 neighbouring
// bytes of a row, and its xq bytes are one broadcast load per row and
// row of M. Nibbles are sign-extended and multiplied in s32 (integer
// multiply-add; __dp4a later). The 8 warps' s32 partial sums meet in
// shared memory through integer atomics, which are exact in any order;
// then each (row, group, column) term d · (xs · ws) is written, rounded
// as the TPU kernel rounds it (no fused multiply-add), to an (M,
// n_groups, N) f32 scratch the wrapper allocates. Pass 2 sums the terms
// of each output in group order and rounds to bf16. The scratch costs
// 2·M·n_groups·N·4 bytes of extra traffic (12% of the weight bytes at
// M = 1); it buys parallelism over K without reordering the f32 sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 128;              // columns per block: 32 lanes × 4 bytes
constexpr int WARPS = 8;             // row lanes
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 8;          // rows of M per block
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ int low_nibble(int b) { return (int)((unsigned)b << 28) >> 28; }
__device__ __forceinline__ int high_nibble(int b) { return (int)((unsigned)b << 24) >> 28; }

template <int MC>
__global__ void __launch_bounds__(THREADS)
s8g4_terms_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ w, const float* __restrict__ ws,
                  float* __restrict__ terms, int m, int k, int n, int n_groups) {
    __shared__ int sums[MC * 2 * BN];    // [row][low, high][column]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int row_lane = tid / 32;
    const int n0 = blockIdx.x * BN;
    const int pair = blockIdx.y;         // low group `pair`, high group pair + n_groups/2
    const int m0 = blockIdx.z * MAX_ROWS;
    const int group = k / n_groups;
    const int half = k / 2;
    const int col = n0 + lane * 4;

    for (int i = tid; i < MC * 2 * BN; i += THREADS) sums[i] = 0;

    int acc_lo[MC][4], acc_hi[MC][4];
#pragma unroll
    for (int r = 0; r < MC; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_lo[r][j] = acc_hi[r][j] = 0;

    if (col < n) {
        const int end = (pair + 1) * group;
#pragma unroll 4
        for (int row = pair * group + row_lane; row < end; row += WARPS) {
            const char4 q = *reinterpret_cast<const char4*>(w + (long long)row * n + col);
            const int lo[4] = {low_nibble(q.x), low_nibble(q.y), low_nibble(q.z),
                               low_nibble(q.w)};
            const int hi[4] = {high_nibble(q.x), high_nibble(q.y), high_nibble(q.z),
                               high_nibble(q.w)};
#pragma unroll
            for (int r = 0; r < MC; ++r) {
                if (m0 + r < m) {
                    const int8_t* xrow = xq + (long long)(m0 + r) * k;
                    const int xl = xrow[row];
                    const int xh = xrow[row + half];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        acc_lo[r][j] += xl * lo[j];
                        acc_hi[r][j] += xh * hi[j];
                    }
                }
            }
        }
    }
    __syncthreads();                     // sums are zeroed
    if (col < n) {
#pragma unroll
        for (int r = 0; r < MC; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                atomicAdd(&sums[(r * 2) * BN + lane * 4 + j], acc_lo[r][j]);
                atomicAdd(&sums[(r * 2 + 1) * BN + lane * 4 + j], acc_hi[r][j]);
            }
    }
    __syncthreads();

    for (int i = tid; i < MC * 2 * BN; i += THREADS) {
        const int r = i / (2 * BN);
        const int h = (i / BN) % 2;
        const int c = n0 + i % BN;
        if (m0 + r < m && c < n) {
            const int g = pair + h * (n_groups / 2);
            const long long mg = (long long)(m0 + r) * n_groups + g;
            const float s = __fmul_rn(xs[mg], ws[(long long)g * n + c]);
            terms[mg * n + c] = __fmul_rn((float)sums[i], s);
        }
    }
}

__global__ void __launch_bounds__(SUM_THREADS)
s8g4_sum_kernel(const float* __restrict__ terms, __nv_bfloat16* __restrict__ out,
                int n, int n_groups) {
    const int c = blockIdx.x * SUM_THREADS + threadIdx.x;
    const long long row = blockIdx.y;
    if (c >= n) return;
    const float* t = terms + row * n_groups * n + c;
    float acc = 0.0f;
    for (int g = 0; g < n_groups; ++g) acc = __fadd_rn(acc, t[(long long)g * n]);
    out[row * n + c] = __float2bfloat16(acc);
}

template <int MC>
void launch_terms(const int8_t* xq, const float* xs, const int8_t* w, const float* ws,
                  float* terms, int m, int k, int n, int n_groups, cudaStream_t stream) {
    const dim3 grid((n + BN - 1) / BN, n_groups / 2, (m + MAX_ROWS - 1) / MAX_ROWS);
    s8g4_terms_kernel<MC><<<grid, THREADS, 0, stream>>>(xq, xs, w, ws, terms, m, k, n,
                                                        n_groups);
}

}  // namespace

// xq (m, k) int8, xs (m, n_groups) f32, w (k/2, n) packed int8, ws
// (n_groups, n) f32, terms (m, n_groups, n) f32 scratch, out (m, n) bf16;
// all dense, n a multiple of 4, n_groups even and dividing k.
// Returns cudaGetLastError() after the two launches.
extern "C" int tww_int4_matmul_s8(const void* xq, const void* xs, const void* w,
                                  const void* ws, void* terms, void* out, int m, int k, int n,
                                  int n_groups, void* stream) {
    const auto* xq_ = static_cast<const int8_t*>(xq);
    const auto* xs_ = static_cast<const float*>(xs);
    const auto* w_ = static_cast<const int8_t*>(w);
    const auto* ws_ = static_cast<const float*>(ws);
    auto* terms_ = static_cast<float*>(terms);
    const auto s = (cudaStream_t)stream;
    // the fewest rows a block must hold: M = 1 on the decode path
    if (m == 1)
        launch_terms<1>(xq_, xs_, w_, ws_, terms_, m, k, n, n_groups, s);
    else if (m == 2)
        launch_terms<2>(xq_, xs_, w_, ws_, terms_, m, k, n, n_groups, s);
    else if (m <= 4)
        launch_terms<4>(xq_, xs_, w_, ws_, terms_, m, k, n, n_groups, s);
    else
        launch_terms<MAX_ROWS>(xq_, xs_, w_, ws_, terms_, m, k, n, n_groups, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    s8g4_sum_kernel<<<dim3((n + SUM_THREADS - 1) / SUM_THREADS, m), SUM_THREADS, 0, s>>>(
        terms_, static_cast<__nv_bfloat16*>(out), n, n_groups);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_int4_matmul_s8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
