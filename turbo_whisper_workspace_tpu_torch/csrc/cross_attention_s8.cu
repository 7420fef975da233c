// Decoder cross-attention over int8 K/V with int8 queries and int8
// softmax weights (both products s8×s8 into s32) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// cross_attention_s8 (body _bd_attn_s8_kernel, pallas_call at :320), the
// opt-in twin of cross_attention_int8. Only the math is kept; the TPU's
// block-diagonal packing of all heads into one matrix product is a trick
// for its 128x128 matrix unit and has no place here. Per (b, h) and query
// row, with the TPU kernel's rounding points:
//   q'  = bf16(q · k_scale · d^-1/2 · log2 e)
//   qs  = max(max|q'|, 1e-30) / 127,  q8 = clip(rint(q' / qs), ±127)
//   s_t = f32(Σ_d q8 · K[d, t]) · qs          (t ≥ seq_len: -1e30)
//   p_t = exp2(s_t - max s),  w_t = p_t · (1 / Σ p)
//   ws  = max(max w, 1e-30) / 127,  w8 = rint(w / ws)   (no clip: w ≤ max w)
//   o_d = bf16((f32(Σ_t w8 · V[t, d]) · ws) · v_scale)
// Since max p = exp2(0) = 1 exactly, max w is 1 / Σ p itself.
//
// What bounds it on the H100: at a decode step (Tq = 1) it reads the
// whole int8 K and V of every (b, h) at t < seq_len, 2·B·H·64·seq_len
// bytes, and does about 2 integer operations per byte, so it is bound
// by HBM (3.35 TB/s), like cross_attention_int8. The design aims at
// reading each K/V byte once, coalesced, with one dp4a for 4 products.
//
// Design: one block of 256 threads per (b·h, chunk of up to 8 query
// rows). Warp r quantizes query row r into shared memory. Scores: each
// thread owns 4 neighbouring key columns; K (64, Tpad) holds the 4 bytes
// one dp4a needs a row apart, so the thread reads a 4x4 byte block (rows
// d..d+3, its 4 columns, one 32-bit load a row: a warp reads 128
// contiguous bytes per row) and transposes it with __byte_perm. Scores
// and then the int8 weights of the chunk live in shared memory (Tq·Tpad
// f32 + Tq·Tpad bytes), where the row max and sum are reduced across the
// block. PV: 16 threads cover one key quad's 64 V columns of the head
// (4x4 blocks again, transposed), 16 key quads at a time; the exact s32
// partial sums meet through warp shuffles and shared memory. Keys past
// seq_len are neither read nor summed. Later work: split the keys over
// more blocks at Tq = 1 (160 blocks at B = 8 do not fill 132 SMs with
// enough loads in flight), and 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "int8_blocks.cuh"

namespace {

constexpr int D = 64;                 // head dim
constexpr int RQ = 8;                 // query rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int V_LANES = D / 4;        // threads per key quad in PV (4 dims each)
constexpr int V_QUADS = THREADS / V_LANES;  // key quads in flight per PV pass
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;     // the TPU kernel's mask value

static_assert(RQ == WARPS, "warp r quantizes query row r");
static_assert(V_LANES == 16, "PV reduction pairs lanes l and l^16");

__device__ float block_max(float v, float* buf) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    __syncthreads();                  // buf may still be read by a prior call
    if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
    __syncthreads();
    v = buf[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = fmaxf(v, buf[w]);
    return v;
}

__device__ float block_sum(float v, float* buf) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    __syncthreads();
    if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
    __syncthreads();
    v = buf[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += buf[w];
    return v;
}

__device__ __forceinline__ int quantize_q(float v, float qs) {
    return (int)fminf(fmaxf(rintf(v / qs), -127.0f), 127.0f);
}

__global__ void __launch_bounds__(THREADS)
cross_attention_s8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H, Tq, 64)
                          const int8_t* __restrict__ kq,        // (B, H, 64, Tpad)
                          const int8_t* __restrict__ vq,        // (B, Tpad, H·64)
                          const float* __restrict__ k_scale,    // (B, H)
                          const float* __restrict__ v_scale,    // (B, H)
                          __nv_bfloat16* __restrict__ o,        // (B, H, Tq, 64)
                          int n_head, int tq, int tpad, int seq_len) {
    extern __shared__ float scores[];                 // (rows, Tpad) f32, then
    const int rows = min(RQ, tq);                     // (rows, Tpad) int8 weights
    int8_t* w8 = reinterpret_cast<int8_t*>(scores + (size_t)rows * tpad);
    __shared__ unsigned q8[RQ][D / 4];                // int8 queries, 4 dims a word
    __shared__ float qscale[RQ];
    __shared__ float wscale[RQ];
    __shared__ float red[WARPS];
    __shared__ int part[WARPS][RQ][D];

    const int bh = blockIdx.x;
    const int b = bh / n_head;
    const int h = bh % n_head;
    const int r0 = blockIdx.y * RQ;
    const int nr = min(RQ, tq - r0);
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;

    // query row `warp`: fold k_scale · d^-1/2 · log2 e in, round to bf16,
    // quantize per row (rows past the chunk are zeros)
    {
        float v0 = 0.0f, v1 = 0.0f;
        if (warp < nr) {
            const float qk = k_scale[bh] * SCALE_LOG2;
            const __nv_bfloat16* qrow = q + ((size_t)bh * tq + r0 + warp) * D;
            v0 = __bfloat162float(__float2bfloat16(__bfloat162float(qrow[lane]) * qk));
            v1 = __bfloat162float(__float2bfloat16(__bfloat162float(qrow[lane + 32]) * qk));
        }
        float amax = fmaxf(fabsf(v0), fabsf(v1));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        const float qs = fmaxf(amax, 1e-30f) / 127.0f;
        int8_t* qrow8 = reinterpret_cast<int8_t*>(q8[warp]);
        qrow8[lane] = (int8_t)quantize_q(v0, qs);
        qrow8[lane + 32] = (int8_t)quantize_q(v1, qs);
        if (lane == 0) qscale[warp] = qs;
    }
    __syncthreads();

    // scores: thread g owns key columns 4g..4g+3
    const int8_t* kh = kq + (size_t)bh * D * tpad;
    for (int g = tid; g < tpad / 4; g += THREADS) {
        const int t0 = g * 4;
        int acc[RQ][4];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = 0;
        if (t0 < seq_len) {
#pragma unroll 4
            for (int d = 0; d < D; d += 4) {
                unsigned rows4[4], cols4[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    rows4[i] = *reinterpret_cast<const unsigned*>(kh + (size_t)(d + i) * tpad + t0);
                transpose4x4(rows4, cols4);           // cols4[j] = K[d..d+3, t0 + j]
#pragma unroll
                for (int r = 0; r < RQ; ++r) {
                    const int qw = (int)q8[r][d / 4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a((int)cols4[j], qw, acc[r][j]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            if (r < nr) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    scores[r * tpad + t0 + j] =
                        (t0 + j < seq_len) ? __fmul_rn((float)acc[r][j], qscale[r]) : NEG_INF;
            }
        }
    }
    __syncthreads();

    // softmax per query row, then the weights quantized to int8
    for (int r = 0; r < nr; ++r) {
        float* srow = scores + r * tpad;
        float mx = -INFINITY;
        for (int t = tid; t < seq_len; t += THREADS) mx = fmaxf(mx, srow[t]);
        mx = block_max(mx, red);
        float sum = 0.0f;
        for (int t = tid; t < seq_len; t += THREADS) {
            const float p = exp2f(srow[t] - mx);
            srow[t] = p;
            sum += p;
        }
        sum = block_sum(sum, red);
        const float inv = 1.0f / sum;
        const float ws = fmaxf(inv, 1e-30f) / 127.0f;     // max w = 1 · inv
        int8_t* wrow = w8 + r * tpad;
        for (int t = tid; t < tpad; t += THREADS)
            wrow[t] = (t < seq_len) ? (int8_t)(int)rintf(__fmul_rn(srow[t], inv) / ws) : 0;
        if (tid == 0) wscale[r] = ws;
    }
    __syncthreads();

    // PV: thread (key quad stream kg, dims 4·dq..4·dq+3) of head h's V columns
    const int dq = tid % V_LANES;
    const int kg = tid / V_LANES;
    const size_t vstride = (size_t)n_head * D;
    const int8_t* vh = vq + (size_t)b * tpad * vstride + (size_t)h * D + dq * 4;
    int acc[RQ][4];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    for (int t0 = kg * 4; t0 < seq_len; t0 += V_QUADS * 4) {
        unsigned rows4[4], cols4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            rows4[i] = *reinterpret_cast<const unsigned*>(vh + (size_t)(t0 + i) * vstride);
        transpose4x4(rows4, cols4);                   // cols4[j] = V[t0..t0+3, 4·dq + j]
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            if (r < nr) {
                const int ww = *reinterpret_cast<const int*>(w8 + r * tpad + t0);
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a((int)cols4[j], ww, acc[r][j]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
    if (lane < V_LANES) {
#pragma unroll
        for (int r = 0; r < RQ; ++r)
            if (r < nr)
#pragma unroll
                for (int j = 0; j < 4; ++j) part[warp][r][dq * 4 + j] = acc[r][j];
    }
    __syncthreads();

    for (int i = tid; i < nr * D; i += THREADS) {
        const int r = i / D;
        const int d = i % D;
        int sum = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[w][r][d];
        const float full = __fmul_rn((float)sum, wscale[r]);
        o[((size_t)bh * tq + r0 + r) * D + d] = __float2bfloat16(__fmul_rn(full, v_scale[bh]));
    }
}

}  // namespace

// q, o: (batch, n_head, tq, 64) bf16; kq: (batch, n_head, 64, tpad) int8;
// vq: (batch, tpad, n_head·64) int8; k_scale, v_scale: (batch, n_head)
// f32. All contiguous; tpad a multiple of 4; 1 ≤ seq_len ≤ tpad.
// Returns cudaGetLastError() after the launch.
extern "C" int tww_cross_attention_s8(const void* q, const void* kq, const void* vq,
                                      const void* k_scale, const void* v_scale, void* o,
                                      int batch, int n_head, int tq, int tpad, int seq_len,
                                      void* stream) {
    const int rows = tq < RQ ? tq : RQ;
    const size_t smem = (size_t)rows * tpad * (sizeof(float) + sizeof(int8_t));
    // ~17 KB of static shared memory: above 24 KB of dynamic the 48 KB
    // default is not enough
    if (smem > 24 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            cross_attention_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(batch * n_head, (tq + RQ - 1) / RQ);
    cross_attention_s8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const int8_t*>(vq), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(o), n_head, tq,
        tpad, seq_len);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_cross_attention_s8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
