// W4A8 matmul on the tensor cores (int8 activations with per-group
// scales × grouped int4 weights) for Hopper (sm_90a), hand-written CUDA
// C++.
//
// Replaces the TPU kernel scripts/profile_llm_ops.py: s8g4_matmul (body
// _s8g4_kernel, pallas_call at :160), the LLM-ops profiler's grouped-int4
// prototype. Its math is that of int4_matmul_s8 (ops/quant.py): xq (M, K)
// int8 with scales xs (M, n_groups) f32; the weight packed (K/2, N) int8,
// low nibble row r, high nibble row r + K/2, sign-extended, scales ws
// (n_groups, N) f32. For each group g (G = K/n_groups rows) an exact s32
// dot d_g = Σ xq·w, then, groups in order, acc = acc + f32(d_g) · (xs[m,
// g] · ws[g, n]) in f32; out bf16. Bit-equal to its plain version.
//
// What bounds it on the H100: on the profiler's path M = 1, a GEMV that
// reads every packed weight byte once (2 nibbles, 4 operations): HBM-
// bound. A 3072 × 8192 projection is 12.6 MB of nibbles + 0.8 MB of
// scales → 4.0 µs at 3.35 TB/s.
//
// Design, unlike int4_matmul_s8's CUDA-core dp4a GEMV with an f32
// scratch and a second pass: int8 mma on the tensor cores (m16n8k32, M
// padded to 16 by masking), one pass, nothing but the output written to
// device memory. One block of 8 warps takes 32 columns and a 16-row tile
// of M and walks the group pairs (the G packed rows whose low nibbles are
// group p and high nibbles group p + n_groups/2) in chunks of 8: warp w
// takes pair p, reads each packed row once as 4x4 byte blocks transposed
// with __byte_perm (int8_blocks.cuh), splits the two nibble planes with a
// per-byte sign extension, and runs G/32 mma steps into one s32
// accumulator set per plane. After those steps (4 at G = 128) it writes
// each group's term f32(d) · (xs · ws) to shared memory. The low groups'
// terms are added to the running f32 sums in group order after each
// chunk; the high groups' terms stay in shared memory for the whole sweep
// and are added, in order, after the last chunk. So the f32 sum runs in
// group order and every weight byte is read once, for (n_groups/2 + 8) ·
// min(M, 16) · 32 f32 of shared memory (5 KB at M = 1, K = 8192).
// Later work: more columns per warp and split K over blocks at small N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_blocks.cuh"

namespace {

constexpr int BN = 32;               // columns per block: four n8 tiles
constexpr int BM = 16;               // rows of M per block: the mma's M
constexpr int WARPS = 8;             // group pairs in flight
constexpr int THREADS = 32 * WARPS;
constexpr int PER_THREAD = BM * BN / THREADS;   // running sums a thread keeps

// the signed nibbles of 4 packed bytes (low plane: shift 0, high: 4), one
// s8 a byte: per-byte (v ^ 8) - 8 sign-extends a 4-bit v
__device__ __forceinline__ unsigned nibbles(unsigned packed, int shift) {
    return __vsub4(((packed >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// one pair's s32 dots of a group → its f32 terms f32(d) · (xs · ws) at
// dst (mt, BN), for the tile's real rows
__device__ __forceinline__ void write_terms(const int c[4][4], int gi, float* dst,
                                            const float* xs, const float* ws, int m, int n,
                                            int n_groups, int m0, int n0, int g, int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e / 2);
        if (m0 + r >= m) continue;
        const float x_scale = xs[(long long)(m0 + r) * n_groups + gi];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = acc_column(j, e, t);
            const float w_scale = n0 + col < n ? ws[(long long)gi * n + n0 + col] : 0.0f;
            dst[r * BN + col] = __fmul_rn((float)c[j][e], __fmul_rn(x_scale, w_scale));
        }
    }
}

__global__ void __launch_bounds__(THREADS)
s8g4_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int m, int k, int n, int n_groups) {
    extern __shared__ float terms[];
    const int mt = min(BM, m);                       // rows the terms hold
    const int half = n_groups / 2;
    const int group = k / n_groups;
    float* hi_terms = terms;                         // (half, mt, BN): groups half..
    float* lo_terms = terms + (long long)half * mt * BN;   // (WARPS, mt, BN): a chunk

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;

    float acc[PER_THREAD];               // element tid + i·THREADS of (mt, BN)
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.0f;

    for (int p0 = 0; p0 < half; p0 += WARPS) {
        const int p = p0 + warp;
        if (p < half) {
            int c_lo[4][4], c_hi[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) c_lo[j][e] = c_hi[j][e] = 0;
            for (int s = 0; s < group; s += 32) {
                const int r = p * group + s;         // packed row of this k32 step
                unsigned b[4][2], a_lo[4], a_hi[4];
                load_b(w, k / 2, n, n0, r, g, t, b);
                load_a(xq, m, k, m0, r, g, t, a_lo);           // group p
                load_a(xq, m, k, m0, r + k / 2, g, t, a_hi);   // group p + half
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    mma_s8(c_lo[j], a_lo, nibbles(b[j][0], 0), nibbles(b[j][1], 0));
                    mma_s8(c_hi[j], a_hi, nibbles(b[j][0], 4), nibbles(b[j][1], 4));
                }
            }
            write_terms(c_lo, p, lo_terms + (long long)warp * mt * BN, xs, ws, m, n,
                        n_groups, m0, n0, g, t);
            write_terms(c_hi, p + half, hi_terms + (long long)p * mt * BN, xs, ws, m, n,
                        n_groups, m0, n0, g, t);
        }
        __syncthreads();
        // the chunk's low groups, in order
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int el = tid + i * THREADS;
            if (el < mt * BN)
                for (int q = 0; q < WARPS && p0 + q < half; ++q)
                    acc[i] = __fadd_rn(acc[i], lo_terms[q * mt * BN + el]);
        }
        __syncthreads();                 // the next chunk rewrites lo_terms
    }
    // then the high groups, in order
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int el = tid + i * THREADS;
        if (el >= mt * BN) continue;
        for (int p = 0; p < half; ++p)
            acc[i] = __fadd_rn(acc[i], hi_terms[(long long)p * mt * BN + el]);
        const int row = m0 + el / BN;
        const int col = n0 + el % BN;
        if (row < m && col < n) out[(long long)row * n + col] = __float2bfloat16(acc[i]);
    }
}

}  // namespace

// Dynamic shared memory of a launch: the high groups' terms and one
// chunk of low groups' terms.
static size_t terms_bytes(int m, int n_groups) {
    const int mt = m < BM ? m : BM;
    return (size_t)(n_groups / 2 + WARPS) * mt * BN * sizeof(float);
}

// xq (m, k) int8, xs (m, n_groups) f32, w (k/2, n) packed int8, ws
// (n_groups, n) f32, out (m, n) bf16; all dense, n a multiple of 4,
// n_groups even and dividing k, k / n_groups a multiple of 32.
// Returns cudaGetLastError() after the launch.
extern "C" int tww_s8g4_matmul(const void* xq, const void* xs, const void* w, const void* ws,
                               void* out, int m, int k, int n, int n_groups, void* stream) {
    const size_t smem = terms_bytes(m, n_groups);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            s8g4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    s8g4_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(w), static_cast<const float*>(ws),
        static_cast<__nv_bfloat16*>(out), m, k, n, n_groups);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_s8g4_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
