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
// What bounds it on the H100: on the profiler's path M = 1, a GEMV that
// reads every weight byte once for 2 operations: HBM-bound. The lm_head
// of llama-3.2-3b, 3072 × 128256 int8, is 394 MB → 0.118 ms at 3.35 TB/s;
// a 3072 × 8192 projection 25 MB → 7.5 µs.
//
// Design: the int8 operands go to the tensor cores, mma.sync m16n8k32
// (s8 × s8 → s32), with M padded to 16 by masking the A fragment's rows.
// One block of 8 warps takes 32 columns (four n8 tiles) and a 16-row tile
// of M; the warps split K in k32 steps (warp w takes steps w, w + 8, ...)
// so that each block keeps 8 warps of loads in flight. The mma wants B
// K-major, 4 consecutive k of one column in a register, while W is (K, N)
// row-major: each lane reads two 4x4 byte blocks straight from global
// memory (one 32-bit load a row; a warp's load covers 4 rows × 32
// contiguous bytes) and transposes them with __byte_perm, with the tiles'
// columns permuted so that no byte goes through shared memory
// (int8_blocks.cuh). The 8 warps' s32 sums meet in shared memory through
// integer atomics, exact in any order, and 256 threads apply the two
// scales. Ragged N and K are masked in the kernel: no padded copy of W.
// Later work: split K over blocks at small N (a 3072 × 1024 projection
// gives 32 blocks), wider loads, and a TMA/cp.async pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_blocks.cuh"

namespace {

constexpr int BN = 32;               // columns per block: four n8 tiles
constexpr int BM = 16;               // rows of M per block: the mma's M
constexpr int WARPS = 8;             // split K
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
s8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
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

}  // namespace

// xq (m, k) int8, xs (m, 1) f32, w (k, n) int8, ws (n,) f32, out (m, n)
// bf16; all dense, k and n multiples of 4.
// Returns cudaGetLastError() after the launch.
extern "C" int tww_s8_matmul(const void* xq, const void* xs, const void* w, const void* ws,
                             void* out, int m, int k, int n, void* stream) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    s8_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(w), static_cast<const float*>(ws),
        static_cast<__nv_bfloat16*>(out), m, k, n);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_s8_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
