// Weight-only int8 matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/quant.py:
// int8_matmul (body _q_matmul_kernel, pallas_call at :62):
// out = x @ W with W[k, n] = bf16(bf16(w_q[k, n]) · bf16(scale[n])), the
// product rounded once to bf16, bf16 operands, f32 sums, bf16 out.
//
// What bounds it on the H100: on the LLM's path it is the int8 lm_head of
// the prefill, M = P prompt rows, K = 4096, N = 128256. At M = 512 it
// does 2·M·K·N = 538 GFLOP on 0.54 GB of int8 weights, about 1000
// operations per byte, so it is bound by the bf16 tensor cores
// (989 TFLOP/s → 0.544 ms), not by HBM (0.20 ms).
//
// Design: one block of 4 warps per 64×64 output tile; the loop walks K in
// chunks of 32. Each chunk stages the x tile (16-byte loads) and the int8
// W tile (4-byte loads, neighbouring threads on neighbouring columns) in
// shared memory, dequantizing W there with the TPU kernel's rounding
// points; bf16(scale[n]) is read once per block. Each warp multiplies a
// 32×32 quarter of the tile with `nvcuda::wmma` bf16 16×16×16 into f32
// accumulators. Ragged M, N and K are masked in the kernel (zeros in, no
// store out), so the wrapper makes no padded copy of the 525 MB head the
// JAX wrapper pads on every call when N is not a multiple of 512. Blocks
// of the same N tile have neighbouring indices, so they share W in L2.
// Not yet used: wgmma, TMA, a multi-stage ring of tiles, int8 tensor
// cores (the rounding points need the bf16 product).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;               // output rows per block
constexpr int BN = 64;               // output columns per block
constexpr int BK = 32;               // K per chunk
constexpr int THREADS = 128;         // 4 warps, 2×2 over the tile
constexpr int LDX = BK + 8;          // bf16 row stride of the x tile
constexpr int LDW = BN + 8;          // bf16 row stride of the W tile
constexpr int LDO = BN + 4;          // f32 row stride of the output tile

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                   int m, int k, int n) {
    __shared__ __align__(32) __nv_bfloat16 x_s[BM * LDX];
    __shared__ __align__(32) __nv_bfloat16 w_s[BK * LDW];
    __shared__ __align__(32) float o_s[BM * LDO];
    __shared__ float scale_s[BN];

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = (warp / 2) * 32;      // this warp's 32×32 quarter
    const int wn = (warp % 2) * 32;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;

    // bf16(scale[n]): the TPU kernel rounds the scale before the product
    if (tid < BN) {
        const int col = n0 + tid;
        scale_s[tid] = col < n ? __bfloat162float(__float2bfloat16(scale[col])) : 0.0f;
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < k; k0 += BK) {
        __syncthreads();                 // the last chunk's tiles are consumed
        // x tile: BM rows × BK columns, 8 bf16 per thread-load
        for (int i = tid; i < BM * (BK / 8); i += THREADS) {
            const int r = i / (BK / 8);
            const int c = (i % (BK / 8)) * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (m0 + r < m && k0 + c < k)
                val = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * k + k0 + c);
            *reinterpret_cast<uint4*>(x_s + r * LDX + c) = val;
        }
        // W tile: BK rows × BN columns, 4 int8 per thread-load, dequantized
        for (int i = tid; i < BK * (BN / 4); i += THREADS) {
            const int r = i / (BN / 4);
            const int c = (i % (BN / 4)) * 4;
            char4 q = make_char4(0, 0, 0, 0);
            if (k0 + r < k && n0 + c < n)
                q = *reinterpret_cast<const char4*>(w + (long long)(k0 + r) * n + n0 + c);
            __nv_bfloat16* dst = w_s + r * LDW + c;
            // int8 → bf16 is exact, and so is its product with a bf16 scale
            // in f32: the one rounding is the bf16 store
            dst[0] = __float2bfloat16((float)q.x * scale_s[c]);
            dst[1] = __float2bfloat16((float)q.y * scale_s[c + 1]);
            dst[2] = __float2bfloat16((float)q.z * scale_s[c + 2]);
            dst[3] = __float2bfloat16((float)q.w * scale_s[c + 3]);
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], x_s + (wm + 16 * i) * LDX + kk, LDX);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(bf[j], w_s + kk * LDW + wn + 16 * j, LDW);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(o_s + (wm + 16 * i) * LDO + wn + 16 * j, acc[i][j], LDO,
                                    wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
        const int r = i / BN;
        const int c = i % BN;
        if (m0 + r < m && n0 + c < n)
            out[(long long)(m0 + r) * n + n0 + c] = __float2bfloat16(o_s[r * LDO + c]);
    }
}

}  // namespace

// x (m, k) bf16, w (k, n) int8, scale (n,) f32, out (m, n) bf16; all dense,
// k a multiple of 8 and n of 4 (16-byte x rows, 4-byte W loads).
// Returns cudaGetLastError() after the launch.
extern "C" int tww_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                               int m, int k, int n, void* stream) {
    const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
    int8_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, k, n);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_int8_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
