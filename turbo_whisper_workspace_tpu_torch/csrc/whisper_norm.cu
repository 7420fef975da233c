// LayerNorm of the Whisper blocks with the residual add before it, or
// with the decoder's token and position embeddings before it, for Hopper
// (sm_90a), hand-written CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA, which fuses the
// residual add `x + delta` with layer_norm
// (turbo_whisper_workspace_tpu/models/whisper.py:182-189) inside its
// jitted decode loop and encoder, and the embedding gather and add
// (:465-467) with the decoder's first norm. Per row of d values:
//   x' = bf16(x + delta)                        (mode 1)
//   x' = bf16(token_emb[tok] + pos_emb[p + r])  (mode 2, p clamped into [0, n_ctx − t])
//   x' = x                                      (mode 0)
//   mean = Σ x' / d,  var = Σ (x' − mean)² / d  (f32, two passes, as JAX's
//                                                mean and var)
//   h  = bf16(w · ((x' − mean) · rsqrt(var + eps)) + b)   (f32, one fma)
// PyTorch's F.layer_norm on the card takes Welford's statistics, so h
// can move by one bf16 ulp where the last bit of the mean or rstd
// differs (chip_smoke.py counts how often); x' is bit-equal.
//
// What bounds it on the H100: a decode step's 8 or 40 rows of 1280
// values are ~20-200 KB, so the time is the launch and one warp's
// reductions; the encoder's 12000 rows (a bucket of 8 windows) move
// 123 MB, 37 µs at 3.35 TB/s. Design: a warp a row, 8 rows a block,
// 16-byte loads and stores, the row kept in registers between the two
// passes, shuffles only (no shared memory, no block barrier). Where the
// rows fill at most one wave of blocks (a decode step's 8 or 40), the
// time is the latency of one chain, so the weight and bias are requested
// with the row and the chain holds one memory round trip (loaded after
// the statistics: 7.0 µs back to back at 8 rows, 5.2 µs with them up
// front); over more rows (the encoder's) occupancy rules, and the
// registers the early affine holds cost more than they save (51 µs at
// 12000 rows, 66 µs with them up front; PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;   // a warp a row
constexpr int MAXC = 16;             // 8-value chunks a lane: d ≤ 4096

// rows of one wave of blocks, a block an SM: 1056 on the H100's 132 SMs;
// 0 (the late affine everywhere) if the card cannot be asked
int wave_rows() {
    static int rows[64] = {};   // by device, read once
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (rows[dev] == 0 &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
        rows[dev] = ROWS * sms;
    return rows[dev];
}

__device__ __forceinline__ void unpack8(const uint4 raw, float (&v)[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// CPL: 8-value chunks a lane at most (the launch takes the least of 2,
// 4, 5, 8 and 16 that holds d, so the row's registers fit its width; 5 is
// Whisper large's d = 1280). EARLY: the affine's loads beside the row's.
template <int CPL, bool EARLY>
__global__ void __launch_bounds__(THREADS)
norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
            const long long* __restrict__ tokens, const bf16* __restrict__ token_emb,
            const bf16* __restrict__ pos_emb, const long long* __restrict__ pos_at, int pos,
            int n_ctx, const bf16* __restrict__ weight, const bf16* __restrict__ bias,
            bf16* __restrict__ x_out, bf16* __restrict__ h, int m, int d, int t, int mode,
            float eps) {
    const int lane = threadIdx.x % 32;
    const size_t row = (size_t)blockIdx.x * ROWS + threadIdx.x / 32;
    if (row >= (size_t)m) return;
    const int chunks = d / 8;
    const bf16* src = x + row * d;
    const bf16* add = delta + row * d;
    if (mode == 2) {
        long long p = pos_at != nullptr ? *pos_at : (long long)pos;
        p = p < 0 ? 0 : (p > n_ctx - t ? n_ctx - t : p);
        src = token_emb + (size_t)tokens[row] * d;
        add = pos_emb + (size_t)(p + (long long)(row % t)) * d;
    }
    float v[CPL][8];
    uint4 wraw[EARLY ? CPL : 1], braw[EARLY ? CPL : 1];   // the affine's bf16 values
    if constexpr (EARLY) {
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
            const int c = lane + 32 * u;
            if (c < chunks) {
                wraw[u] = *reinterpret_cast<const uint4*>(weight + 8 * c);
                braw[u] = *reinterpret_cast<const uint4*>(bias + 8 * c);
            }
        }
    }
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < chunks) {
            load8(src + 8 * c, v[u]);
            if (mode != 0) {
                float dl[8];
                load8(add + 8 * c, dl);
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    v[u][i] = __bfloat162float(__float2bfloat16(v[u][i] + dl[i]));
                store8(x_out + row * d + 8 * c, v[u]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) sum += v[u][i];
        }
    }
    const float mean = __fdiv_rn(warp_sum(sum), (float)d);
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        if (lane + 32 * u < chunks) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float c = v[u][i] - mean;
                ss = fmaf(c, c, ss);
            }
        }
    }
    const float rstd = rsqrtf(__fdiv_rn(warp_sum(ss), (float)d) + eps);
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < chunks) {
            float w[8], b[8];
            if constexpr (EARLY) {
                unpack8(wraw[u], w);
                unpack8(braw[u], b);
            } else {
                load8(weight + 8 * c, w);
                load8(bias + 8 * c, b);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) v[u][i] = fmaf(w[i], (v[u][i] - mean) * rstd, b[i]);
            store8(h + row * d + 8 * c, v[u]);
        }
    }
}

}  // namespace

// mode 0: h = layer_norm(x); 1: x_out = x + delta, h = layer_norm(x_out);
// 2: x_out = token_emb[tokens] + pos_emb[p + row % t] (tokens: m = B·t
// int64; p an int64 in device memory at pos_at, or the host int pos when
// pos_at is null, clamped into [0, n_ctx − t]), h = layer_norm(x_out).
// x, delta, x_out, h: (m, d) bf16; token_emb (V, d), pos_emb (n_ctx, d),
// weight, bias (d,) bf16; all contiguous and 16-byte aligned; d a
// multiple of 8 up to 4096. Returns cudaGetLastError() after the launch.
extern "C" int tww_whisper_norm(const void* x, const void* delta, const void* tokens,
                                const void* token_emb, const void* pos_emb, const void* pos_at,
                                int pos, int n_ctx, const void* weight, const void* bias,
                                void* x_out, void* h, int m, int d, int t, int mode, float eps,
                                void* stream) {
    if (m < 1 || d < 8 || d % 8 || d > 8 * 32 * MAXC || mode < 0 || mode > 2 ||
        (mode == 2 && (t < 1 || t > n_ctx || m % t)))
        return (int)cudaErrorInvalidValue;
    const int cpl = (d / 8 + 31) / 32;
    const bool early = m <= wave_rows();
    auto pick = [&](auto fe, auto fl) { return early ? fe : fl; };
    auto kernel = cpl <= 2   ? pick(norm_kernel<2, true>, norm_kernel<2, false>)
                  : cpl <= 4 ? pick(norm_kernel<4, true>, norm_kernel<4, false>)
                  : cpl <= 5 ? pick(norm_kernel<5, true>, norm_kernel<5, false>)
                  : cpl <= 8 ? pick(norm_kernel<8, true>, norm_kernel<8, false>)
                             : pick(norm_kernel<MAXC, true>, norm_kernel<MAXC, false>);
    kernel<<<(m + ROWS - 1) / ROWS, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(delta),
        static_cast<const long long*>(tokens), static_cast<const bf16*>(token_emb),
        static_cast<const bf16*>(pos_emb), static_cast<const long long*>(pos_at), pos, n_ctx,
        static_cast<const bf16*>(weight), static_cast<const bf16*>(bias),
        static_cast<bf16*>(x_out), static_cast<bf16*>(h), m, d, t, mode, eps);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_whisper_norm_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
