// SwiGLU of the Llama MLP with the W4A8 activation quantizer of the down
// projection, for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA, which fuses
// silu(gate) · up (turbo_whisper_workspace_tpu/models/llama.py:172-174)
// with quant_act_grouped (ops/quant.py:222) in its layer scan. Per value,
// with the port's bf16 rounding points (models/llama.py):
//   p = bf16(bf16(g · bf16(1 / (1 + exp(−g)))) · u)
// and, where the down projection is int4 at m ≤ 8, per group of G values
//   xs = max(max|p|, 1e-12) / 127,  xq = clamp(rint(p / xs), ±127)
// with IEEE division and rounding half to even, as
// ops/quant.py:quant_act_grouped. The bf16 product is written in every
// case (the projection's input when it is not quantized).
//
// What bounds it on the H100: 4 bytes read and 3 written a value, 100 KB
// a decode step at the 8B width (d_ff 14336): the launch. Design: 256
// threads a block, 8 values a thread (16-byte loads and stores), a
// group's G/8 threads neighbouring lanes of one warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

__global__ void __launch_bounds__(THREADS)
swiglu_quant_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                    bf16* __restrict__ out, int8_t* __restrict__ xq, float* __restrict__ xs,
                    int f, int group) {
    const size_t row = blockIdx.y;
    const int chunks = f / 8;
    const int c = blockIdx.x * THREADS + threadIdx.x;
    const bool valid = c < chunks;
    float p[8];
    if (valid) {
        const uint4 graw = *reinterpret_cast<const uint4*>(gate + row * f + 8 * (size_t)c);
        const uint4 uraw = *reinterpret_cast<const uint4*>(up + row * f + 8 * (size_t)c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&graw);
        const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&uraw);
        uint4 oraw;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&oraw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 g = __bfloat1622float2(g2[i]);
            const float2 u = __bfloat1622float2(u2[i]);
            const float sx = round_bf16(1.0f / (1.0f + expf(-g.x)));
            const float sy = round_bf16(1.0f / (1.0f + expf(-g.y)));
            p[2 * i] = round_bf16(round_bf16(g.x * sx) * u.x);
            p[2 * i + 1] = round_bf16(round_bf16(g.y * sy) * u.y);
            o2[i] = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
        }
        *reinterpret_cast<uint4*>(out + row * f + 8 * (size_t)c) = oraw;
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = 0.0f;
    }
    if (group == 0) return;          // the same for every thread
    const int tpg = group / 8;
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(p[i]));
    for (int off = tpg / 2; off >= 1; off /= 2)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (!valid) return;
    const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float qv = fminf(fmaxf(rintf(__fdiv_rn(p[i], s)), -127.0f), 127.0f);
        w[i / 4] |= (uint32_t)(uint8_t)(int8_t)qv << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(xq + row * f + 8 * (size_t)c) = make_uint2(w[0], w[1]);
    if (c % tpg == 0) xs[row * (f / group) + c / tpg] = s;
}

}  // namespace

// gate, up, out: (m, f) bf16; xq: (m, f) int8; xs: (m, f / group) f32.
// All contiguous, 16-byte aligned (xs 4-byte); f a multiple of 8.
// group 0: no quantizer (xq, xs unused); else f a multiple of group and
// group / 8 a power of two at most 32. Returns cudaGetLastError() after
// the launch.
extern "C" int tww_llama_swiglu_quant(const void* gate, const void* up, void* out, void* xq,
                                      void* xs, int m, int f, int group, void* stream) {
    const int tpg = group / 8;
    if (m < 1 || m > 65535 || f < 8 || f % 8 ||
        (group && (group % 8 || f % group || tpg > 32 || (tpg & (tpg - 1)))))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((f / 8 + THREADS - 1) / THREADS, m);
    swiglu_quant_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(gate), static_cast<const bf16*>(up), static_cast<bf16*>(out),
        static_cast<int8_t*>(xq), static_cast<float*>(xs), f, group);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_llama_swiglu_quant_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
