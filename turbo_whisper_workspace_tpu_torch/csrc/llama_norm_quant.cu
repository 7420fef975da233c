// RMSNorm of the Llama layer with the residual add before it and the
// W4A8 activation quantizer after it, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA, which fuses the
// residual add `x + delta`, rms_norm
// (turbo_whisper_workspace_tpu/models/llama.py:89-92) and
// quant_act_grouped (turbo_whisper_workspace_tpu/ops/quant.py:222) into
// a few passes of its layer scan, and runs the quantizer once for the
// input that q, k and v (or gate and up) share. Per row of d values:
//   x' = bf16(x + delta)                                  (mode 2)
//   h  = bf16(bf16(x' · rsqrt(Σ x'² / d + eps)) · scale)  (modes 1, 2)
//   xs = max(max|y|, 1e-12) / 127,  xq = clamp(rint(y / xs), ±127)
// for each group of G values of y (h, or x itself in mode 0, which
// quantizes the attention output for the out projection), with IEEE
// division and rounding half to even as ops/quant.py:quant_act_grouped.
// The sum of squares is a block reduction in another order than
// PyTorch's; a last-bit change of the rsqrt can move a bf16 h by one ulp,
// and then an xq by 1 (chip_smoke.py counts how often).
//
// What bounds it on the H100: a decode step's row is 4096 values, 8 KB
// in and ~13 KB out: the time is the launch and one block reduction.
// Design: one block of 256 threads a row, 8 values a thread (16-byte
// loads and stores), the row kept in registers between the two passes;
// a group's G/8 threads are neighbouring lanes of one warp, so its
// |max| takes log2(G/8) shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int MAXC = 8;              // 8-value chunks a thread: d ≤ 16384

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
}

// quant_act_grouped of chunk c's 8 values (every lane calls it: the
// group's |max| is a shuffle over its tpg neighbouring lanes)
__device__ __forceinline__ void quantize8(const float (&v)[8], bool valid, int c, int tpg,
                                          int8_t* xq, float* xs) {
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
    for (int off = tpg / 2; off >= 1; off /= 2)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (!valid) return;
    const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float qv = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.0f), 127.0f);
        w[i / 4] |= (uint32_t)(uint8_t)(int8_t)qv << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(xq + 8 * (size_t)c) = make_uint2(w[0], w[1]);
    if (c % tpg == 0) xs[c / tpg] = s;
}

__global__ void __launch_bounds__(THREADS)
norm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                  const bf16* __restrict__ scale, bf16* __restrict__ x_out,
                  bf16* __restrict__ h, int8_t* __restrict__ xq, float* __restrict__ xs,
                  int d, int group, int mode, float eps, float inv_d) {
    __shared__ float wsum[THREADS / 32];
    const size_t row = blockIdx.x;
    const int chunks = d / 8;
    const int tid = threadIdx.x;
    float v[MAXC][8];
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < MAXC; ++u) {
        const int c = tid + u * THREADS;
        if (c < chunks) {
            load8(x + row * d + 8 * c, v[u]);
            if (mode == 2) {
                float dl[8];
                load8(delta + row * d + 8 * c, dl);
#pragma unroll
                for (int i = 0; i < 8; ++i) v[u][i] = round_bf16(v[u][i] + dl[i]);
                store8(x_out + row * d + 8 * c, v[u]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) ss = fmaf(v[u][i], v[u][i], ss);
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[u][i] = 0.0f;
        }
    }
    if (mode != 0) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (tid % 32 == 0) wsum[tid / 32] = ss;
        __syncthreads();
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) total += wsum[w];
        const float r = rsqrtf(total * inv_d + eps);
#pragma unroll
        for (int u = 0; u < MAXC; ++u) {
            const int c = tid + u * THREADS;
            if (c < chunks) {
                float sc[8];
                load8(scale + 8 * c, sc);
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    v[u][i] = round_bf16(round_bf16(v[u][i] * r) * sc[i]);
                store8(h + row * d + 8 * c, v[u]);
            }
        }
    }
    if (group > 0) {
        const int n_groups = d / group;
#pragma unroll
        for (int u = 0; u < MAXC; ++u) {
            const int c = tid + u * THREADS;
            if (u * THREADS < chunks)          // the same for every lane of a warp
                quantize8(v[u], c < chunks, c, group / 8, xq + row * d, xs + row * n_groups);
        }
    }
}

}  // namespace

// x, delta, x_out, h: (m, d) bf16; scale: (d,) bf16; xq: (m, d) int8;
// xs: (m, d / group) f32. All contiguous and 16-byte aligned (xs 4-byte);
// d a multiple of 8, at most 16384. mode 0: quantize x (h, delta, x_out
// unused); 1: h = rms_norm(x); 2: x_out = x + delta, h = rms_norm(x_out).
// group 0: no quantizer (xq, xs unused); else d a multiple of group, and
// group / 8 a power of two at most 32. inv_d: 1/d as f32. Returns
// cudaGetLastError() after the launch.
extern "C" int tww_llama_norm_quant(const void* x, const void* delta, const void* scale,
                                    void* x_out, void* h, void* xq, void* xs, int m, int d,
                                    int group, int mode, float eps, float inv_d, void* stream) {
    const int tpg = group / 8;
    if (m < 1 || d < 8 || d % 8 || d > 8 * THREADS * MAXC || mode < 0 || mode > 2 ||
        (group && (group % 8 || d % group || tpg > 32 || (tpg & (tpg - 1)))) ||
        (mode == 0 && group == 0))
        return (int)cudaErrorInvalidValue;
    norm_quant_kernel<<<m, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(delta),
        static_cast<const bf16*>(scale), static_cast<bf16*>(x_out), static_cast<bf16*>(h),
        static_cast<int8_t*>(xq), static_cast<float*>(xs), d, group, mode, eps, inv_d);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_llama_norm_quant_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
