// Grouped int4 weight-only matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/quant.py:
// int4_matmul (body _q4_matmul_kernel with _dequant4_halves, pallas_call
// at :177). The weight is packed (K/2, N) int8: the low nibble of byte
// (r, n) is W row r, the high nibble W row r + K/2, both sign-extended;
// scale (n_groups, N) f32 holds one scale per (group of G = K/n_groups
// rows, column). Each weight is nibble × scale in f32, rounded once to
// bf16 (not int8_matmul's bf16 × bf16 product); out = x_lo @ lo +
// x_hi @ hi over bf16(x) with f32 sums, rounded to bf16.
//
// What bounds it on the H100: on the LLM's path it is every body
// projection of the prefill, M = P prompt rows, (K, N) in {(4096, 4096),
// (4096, 1024), (4096, 14336), (14336, 4096)}. At M = 512, (4096, 14336)
// it does 60.1 GFLOP on 29 MB of packed weights, about 2000 operations
// per byte: bound by the bf16 tensor cores (0.061 ms), not HBM.
//
// Design: int8_matmul.cu's skeleton. One block of 4 warps per 64×64
// output tile walks the K/2 packed rows in chunks of 32. A chunk feeds
// two products: x columns [r0, r0 + 32) against the low nibbles and x
// columns [K/2 + r0, K/2 + r0 + 32) against the high nibbles, so both
// halves of x are staged and both go into the same f32 accumulators.
// Each thread reads 4 packed bytes of one row (neighbouring threads on
// neighbouring columns) and the two f32 scale quads of that row's low
// and high groups (G may be any divisor of K, so the group is found per
// row), and writes the 8 dequantized bf16 weights to shared memory.
// `nvcuda::wmma` bf16 16×16×16 with f32 sums; ragged M and N masked in
// the kernel. Not yet used: wgmma, TMA, a multi-stage ring of tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;               // output rows per block
constexpr int BN = 64;               // output columns per block
constexpr int BK = 32;               // packed rows per chunk (64 rows of W)
constexpr int THREADS = 128;         // 4 warps, 2×2 over the tile
constexpr int LDX = BK + 8;
constexpr int LDW = BN + 8;
constexpr int LDO = BN + 4;

// sign-extended nibbles of a packed byte (shifted as unsigned, then back
// arithmetically, as the JAX kernel's shift_left / shift_right_arithmetic)
__device__ __forceinline__ int low_nibble(int b) { return (int)((unsigned)b << 28) >> 28; }
__device__ __forceinline__ int high_nibble(int b) { return (int)((unsigned)b << 24) >> 28; }

__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                   int m, int k, int n, int group) {
    __shared__ __align__(32) __nv_bfloat16 xlo_s[BM * LDX];
    __shared__ __align__(32) __nv_bfloat16 xhi_s[BM * LDX];
    __shared__ __align__(32) __nv_bfloat16 wlo_s[BK * LDW];
    __shared__ __align__(32) __nv_bfloat16 whi_s[BK * LDW];
    __shared__ __align__(32) float o_s[BM * LDO];

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 32;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int half = k / 2;
    const int half_groups = half / group;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int r0 = 0; r0 < half; r0 += BK) {
        __syncthreads();
        for (int i = tid; i < BM * (BK / 8); i += THREADS) {
            const int r = i / (BK / 8);
            const int c = (i % (BK / 8)) * 8;
            uint4 lo = make_uint4(0u, 0u, 0u, 0u);
            uint4 hi = make_uint4(0u, 0u, 0u, 0u);
            if (m0 + r < m && r0 + c < half) {
                const __nv_bfloat16* row = x + (long long)(m0 + r) * k + r0 + c;
                lo = *reinterpret_cast<const uint4*>(row);
                hi = *reinterpret_cast<const uint4*>(row + half);
            }
            *reinterpret_cast<uint4*>(xlo_s + r * LDX + c) = lo;
            *reinterpret_cast<uint4*>(xhi_s + r * LDX + c) = hi;
        }
        for (int i = tid; i < BK * (BN / 4); i += THREADS) {
            const int r = i / (BN / 4);
            const int c = (i % (BN / 4)) * 4;
            const int row = r0 + r;
            float lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (row < half && n0 + c < n) {
                const char4 q = *reinterpret_cast<const char4*>(w + (long long)row * n + n0 + c);
                const int g = row / group;
                const float4 slo =
                    *reinterpret_cast<const float4*>(scale + (long long)g * n + n0 + c);
                const float4 shi = *reinterpret_cast<const float4*>(
                    scale + (long long)(g + half_groups) * n + n0 + c);
                lo[0] = (float)low_nibble(q.x) * slo.x;
                lo[1] = (float)low_nibble(q.y) * slo.y;
                lo[2] = (float)low_nibble(q.z) * slo.z;
                lo[3] = (float)low_nibble(q.w) * slo.w;
                hi[0] = (float)high_nibble(q.x) * shi.x;
                hi[1] = (float)high_nibble(q.y) * shi.y;
                hi[2] = (float)high_nibble(q.z) * shi.z;
                hi[3] = (float)high_nibble(q.w) * shi.w;
            }
            __nv_bfloat16* dlo = wlo_s + r * LDW + c;
            __nv_bfloat16* dhi = whi_s + r * LDW + c;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                dlo[j] = __float2bfloat16(lo[j]);
                dhi[j] = __float2bfloat16(hi[j]);
            }
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], xlo_s + (wm + 16 * i) * LDX + kk, LDX);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(bf[j], wlo_s + kk * LDW + wn + 16 * j, LDW);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], xhi_s + (wm + 16 * i) * LDX + kk, LDX);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(bf[j], whi_s + kk * LDW + wn + 16 * j, LDW);
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

// x (m, k) bf16, w (k/2, n) packed int8, scale (n_groups, n) f32 (16-byte
// aligned), out (m, n) bf16; all dense, k a multiple of 16, n of 4,
// n_groups even and dividing k. Returns cudaGetLastError() after the launch.
extern "C" int tww_int4_matmul(const void* x, const void* w, const void* scale, void* out,
                               int m, int k, int n, int n_groups, void* stream) {
    const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
    int4_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, k, n,
        k / n_groups);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_int4_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
