// Decode-step self-attention over the int8 self-KV cache for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// self_attention_int8 (body _self_int8_kernel, pallas_call at :413). It
// runs at every beam step of beam search with quantize_cache=True and
// lane_cache=False, where each of the B·K rows owns a physically
// regathered cache. Per (b, h, query row):
//   s = (q · bf16(Kq[t])) · ks[t] · d^-1/2 · log2 e   (f32 sums)
//   s = -inf where t ≥ valid_len
//   w = exp2(s - max) / Σ                              (f32)
//   o = bf16(Σ_t bf16(w · vs[t]) · Vq[t])              (f32 sums)
//
// What bounds it on the H100: one step reads, per (b, h), valid_len int8
// K rows and V rows of 64 bytes and their bf16 scales, and does ~4
// operations per byte, so it is bound by HBM (3.35 TB/s). Only keys
// t < valid_len need be read: valid_len is a kernel argument, not a
// device tensor, so no host sync is needed to pass it.
//
// Design: one block of 256 threads per (b·h, query row). Scores: thread
// per key, each reading its key's 64 contiguous bytes as four 16-byte
// loads; the scores of the row live in shared memory (valid_len f32),
// where the max and sum are reduced across the block. PV: 16 threads
// cover one key's 64 V bytes (char4 each), 16 keys at a time; partial
// sums are combined by warp shuffles and one pass through shared
// memory. Keys t ≥ valid_len are never read. Later work: several rows
// per block (a step has Tq = 1, so a block's K and V bytes feed one
// query), and splitting long caches over more blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int D = 64;                 // head dim
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int V_LANES = D / 4;        // threads per key in PV (char4 each)
constexpr int V_KEYS = THREADS / V_LANES;  // keys in flight per PV pass
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

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

// byte j (0..3) of a packed word, sign-extended
__device__ __forceinline__ float s8(int word, int j) {
    return (float)((int)((unsigned)word << (24 - 8 * j)) >> 24);
}

__global__ void __launch_bounds__(THREADS)
self_attention_int8_kernel(const __nv_bfloat16* __restrict__ q,   // (B·H, Tq, 64)
                           const int8_t* __restrict__ kq,         // (B·H, T, 64)
                           const __nv_bfloat16* __restrict__ ks,  // (B·H, T)
                           const int8_t* __restrict__ vq,         // (B·H, T, 64)
                           const __nv_bfloat16* __restrict__ vs,  // (B·H, T)
                           __nv_bfloat16* __restrict__ o,         // (B·H, Tq, 64)
                           int tq, int t_len, int valid_len) {
    extern __shared__ float w_s[];                    // (valid_len)
    __shared__ float q_s[D];
    __shared__ float red[WARPS];
    __shared__ float part[WARPS][D];

    const size_t bh = blockIdx.x;
    const size_t row = (bh * tq + blockIdx.y) * D;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    if (tid < D) q_s[tid] = __bfloat162float(q[row + tid]);
    __syncthreads();

    // scores: thread per key, its 64 bytes as four 16-byte loads
    const int8_t* kh = kq + bh * t_len * D;
    const __nv_bfloat16* ksh = ks + bh * t_len;
    const __nv_bfloat16* vsh = vs + bh * t_len;
    float mx = -INFINITY;
    for (int t = tid; t < valid_len; t += THREADS) {
        const int4* krow = reinterpret_cast<const int4*>(kh + (size_t)t * D);
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
            const int4 pk = krow[c];
            const int words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
            for (int w = 0; w < 4; ++w)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s = fmaf(q_s[c * 16 + w * 4 + j], s8(words[w], j), s);
        }
        s *= __bfloat162float(ksh[t]) * SCALE_LOG2;
        w_s[t] = s;
        mx = fmaxf(mx, s);
    }
    mx = block_max(mx, red);
    float sum = 0.0f;
    for (int t = tid; t < valid_len; t += THREADS) {
        const float p = exp2f(w_s[t] - mx);
        w_s[t] = p;
        sum += p;
    }
    sum = block_sum(sum, red);
    const float inv = 1.0f / sum;
    // weights × vs, rounded to bf16 before PV
    for (int t = tid; t < valid_len; t += THREADS)
        w_s[t] = __bfloat162float(__float2bfloat16(w_s[t] * inv * __bfloat162float(vsh[t])));
    __syncthreads();

    // PV: thread (key stream kg, dims 4·dq..4·dq+3)
    const int dq = tid % V_LANES;
    const int kg = tid / V_LANES;
    const int8_t* vh = vq + bh * t_len * D + dq * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = kg; t < valid_len; t += V_KEYS) {
        const char4 vv = *reinterpret_cast<const char4*>(vh + (size_t)t * D);
        const float w = w_s[t];
        acc[0] = fmaf(w, (float)vv.x, acc[0]);
        acc[1] = fmaf(w, (float)vv.y, acc[1]);
        acc[2] = fmaf(w, (float)vv.z, acc[2]);
        acc[3] = fmaf(w, (float)vv.w, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
    if (lane < V_LANES) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part[warp][dq * 4 + j] = acc[j];
    }
    __syncthreads();
    if (tid < D) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += part[w][tid];
        o[row + tid] = __float2bfloat16(s);
    }
}

}  // namespace

// q, o: (bh, tq, 64) bf16; kq, vq: (bh, t_len, 64) int8, kq 16-byte
// aligned; ks, vs: (bh, t_len) bf16; bh = batch·n_head. All contiguous;
// 1 ≤ valid_len ≤ t_len. Returns cudaGetLastError() after the launch.
extern "C" int tww_self_attention_int8(const void* q, const void* kq, const void* ks,
                                       const void* vq, const void* vs, void* o, int bh,
                                       int tq, int t_len, int valid_len, void* stream) {
    const size_t smem = (size_t)valid_len * sizeof(float);
    // ~3.4 KB of static shared memory: above 32 KB of dynamic the 48 KB
    // default is not enough
    if (smem > 32 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            self_attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(bh, tq);
    self_attention_int8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const __nv_bfloat16*>(vs), static_cast<__nv_bfloat16*>(o), tq, t_len,
        valid_len);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_self_attention_int8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
