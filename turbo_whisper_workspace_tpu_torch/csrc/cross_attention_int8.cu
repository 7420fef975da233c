// Decoder cross-attention over int8 K/V for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// cross_attention_int8 (body _bd_attn_int8_kernel, pallas_call at :226).
// Only the math is kept; the TPU's block-diagonal packing of all heads
// into one matrix product (_bd_expand/_bd_extract) is a trick for its
// 128x128 matrix unit and has no place here. Per (b, h):
//   q' = bf16(q · k_scale · d^-1/2 · log2 e)
//   s  = q' · K[:, t]            (f32 sums; t ≥ seq_len masked)
//   w  = bf16(exp2(s - max) / Σ)
//   o  = bf16((w · V) · v_scale)  (f32 sums, one rounding at the end)
//
// What bounds it on the H100: at a decode step (Tq = 1) it reads the
// whole int8 K and V of every (b, h), 2·B·H·64·Tpad bytes, and does
// only ~2 operations per byte, so it is bound by HBM (3.35 TB/s). The
// design therefore aims at reading each K/V byte once, coalesced.
//
// Design: one block of 256 threads per (b·h, chunk of 4 query rows).
// Scores: each thread owns 4 neighbouring key columns and reads K
// (64, Tpad) one d-row at a time as char4, so a warp reads 128
// contiguous bytes per row and every K byte feeds all 4 query rows.
// The scores of the chunk live in shared memory (4 · Tpad f32), where
// the row max and sum are reduced across the block. PV: 16 threads
// cover one key's 64 V bytes (char4 each), 16 keys at a time; partial
// sums are combined by warp shuffles and one pass through shared
// memory. Keys past seq_len are neither read nor summed. Later work:
// split the keys over more blocks at Tq = 1 (160 blocks at B = 8 do
// not fill 132 SMs with enough loads in flight), and 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int D = 64;                 // head dim
constexpr int RQ = 4;                 // query rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int V_LANES = D / 4;        // threads per key in PV (char4 each)
constexpr int V_KEYS = THREADS / V_LANES;  // keys in flight per PV pass
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

static_assert(RQ * D == THREADS, "one output element per thread");
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

__global__ void __launch_bounds__(THREADS)
cross_attention_int8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H, Tq, 64)
                            const int8_t* __restrict__ kq,        // (B, H, 64, Tpad)
                            const int8_t* __restrict__ vq,        // (B, Tpad, H·64)
                            const float* __restrict__ k_scale,    // (B, H)
                            const float* __restrict__ v_scale,    // (B, H)
                            __nv_bfloat16* __restrict__ o,        // (B, H, Tq, 64)
                            int n_head, int tq, int tpad, int seq_len) {
    extern __shared__ float scores[];                 // (RQ, Tpad)
    __shared__ float q_s[RQ][D];
    __shared__ float red[WARPS];
    __shared__ float part[WARPS][RQ][D];

    const int bh = blockIdx.x;
    const int b = bh / n_head;
    const int h = bh % n_head;
    const int r0 = blockIdx.y * RQ;
    const int nr = min(RQ, tq - r0);
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;

    // fold k_scale · d^-1/2 · log2 e into q and round to bf16 before the dot
    const float qscale = k_scale[bh] * SCALE_LOG2;
    for (int i = tid; i < RQ * D; i += THREADS) {
        const int r = i / D;
        const int d = i % D;
        float val = 0.0f;
        if (r < nr) {
            const float qv = __bfloat162float(q[((size_t)bh * tq + r0 + r) * D + d]);
            val = __bfloat162float(__float2bfloat16(qv * qscale));
        }
        q_s[r][d] = val;
    }
    __syncthreads();

    // scores: thread g owns key columns 4g..4g+3
    const int8_t* kh = kq + (size_t)bh * D * tpad;
    for (int g = tid; g < tpad / 4; g += THREADS) {
        const int t0 = g * 4;
        float s[RQ][4];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;
        if (t0 < seq_len) {
#pragma unroll 8
            for (int d = 0; d < D; ++d) {
                const char4 kv = *reinterpret_cast<const char4*>(kh + (size_t)d * tpad + t0);
                const float k4[4] = {(float)kv.x, (float)kv.y, (float)kv.z, (float)kv.w};
#pragma unroll
                for (int r = 0; r < RQ; ++r) {
                    const float qv = q_s[r][d];
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv, k4[j], s[r][j]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                scores[r * tpad + t0 + j] = (t0 + j < seq_len) ? s[r][j] : -INFINITY;
    }
    __syncthreads();

    // softmax per query row, weights rounded to bf16 before PV
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
        for (int t = tid; t < seq_len; t += THREADS)
            srow[t] = __bfloat162float(__float2bfloat16(srow[t] * inv));
    }
    __syncthreads();

    // PV: thread (key stream kg, dims 4·dq..4·dq+3) of head h's V columns
    const int dq = tid % V_LANES;
    const int kg = tid / V_LANES;
    const size_t vstride = (size_t)n_head * D;
    const int8_t* vh = vq + (size_t)b * tpad * vstride + (size_t)h * D + dq * 4;
    float acc[RQ][4];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
    for (int t = kg; t < seq_len; t += V_KEYS) {
        const char4 vv = *reinterpret_cast<const char4*>(vh + (size_t)t * vstride);
        const float v4[4] = {(float)vv.x, (float)vv.y, (float)vv.z, (float)vv.w};
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            const float w = scores[r * tpad + t];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(w, v4[j], acc[r][j]);
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
#pragma unroll
            for (int j = 0; j < 4; ++j) part[warp][r][dq * 4 + j] = acc[r][j];
    }
    __syncthreads();

    const int r = tid / D;
    const int d = tid % D;
    if (r < nr) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[w][r][d];
        o[((size_t)bh * tq + r0 + r) * D + d] = __float2bfloat16(sum * v_scale[bh]);
    }
}

}  // namespace

// q, o: (batch, n_head, tq, 64) bf16; kq: (batch, n_head, 64, tpad) int8;
// vq: (batch, tpad, n_head·64) int8; k_scale, v_scale: (batch, n_head)
// f32. All contiguous; tpad a multiple of 4; 1 ≤ seq_len ≤ tpad.
// Returns cudaGetLastError() after the launch.
extern "C" int tww_cross_attention_int8(const void* q, const void* kq, const void* vq,
                                        const void* k_scale, const void* v_scale,
                                        void* o, int batch, int n_head, int tq,
                                        int tpad, int seq_len, void* stream) {
    const size_t smem = (size_t)RQ * tpad * sizeof(float);
    // ~9 KB of static shared memory: above 32 KB of dynamic the 48 KB
    // default is not enough
    if (smem > 32 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            cross_attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(batch * n_head, (tq + RQ - 1) / RQ);
    cross_attention_int8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const int8_t*>(vq), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(o), n_head, tq,
        tpad, seq_len);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_cross_attention_int8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
