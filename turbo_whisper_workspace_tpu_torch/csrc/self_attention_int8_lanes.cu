// Beam-step self-attention over the un-reordered int8 "lane" cache for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// self_attention_int8_lanes (body _bd_self_int8_kernel, pallas_call at
// :524). Beam search never moves the int8 self-KV cache: lane l holds
// whatever hypothesis sat in beam slot l when each position was
// written, and lane_map[b, k, t] names the lane that beam k reads at
// position t. Per (b, h, beam k):
//   s_t = (q_k · bf16(K[l_t, t])) · ks[l_t, t] · d^-1/2 · log2 e, l_t = lane_map[b, k, t]
//   s_t = -inf where t ≥ valid_len
//   w   = exp2(s - max) / Σ                               (f32)
//   o_k = bf16(Σ_t bf16(w_t · vs[l_t, t]) · V[l_t, t])     (f32 sums)
// Only the math is kept. The TPU kernel scores all K·T lane columns for
// every beam and masks the unowned ones with a (B, K, K·T) additive
// bias, packing all heads into one block-diagonal product
// (_bd_expand/_bd_extract) and expanding scales with 0/1 matmuls; those
// serve its 128x128 matrix unit and Mosaic's lack of reshapes. This
// kernel reads lane_map (B, K, T) int32 directly.
//
// What bounds it on the H100: a step needs, per (b, h), the 64 K bytes
// and 64 V bytes of each (lane, t) pair that some beam owns at
// t < valid_len, plus their bf16 scales; it does a few operations per
// byte, so it is bound by HBM (3.35 TB/s). Beams share most of their
// ancestry (the prompt sits in lane 0 for every beam), so the owned
// pairs are far fewer than K·valid_len.
//
// Design: one block of 256 threads per (b, h), all K beams together. It
// reads each owned (lane, t) pair once and scores it for every beam
// that owns it; unowned pairs are never read. Work items are (lane,
// t) pairs, lane-major, so neighbouring threads take neighbouring t of
// one lane, and in the K panel (B, H·64, K·T) those are neighbouring
// bytes of each of the 64 rows. Scores and the lane map of the block
// live in shared memory (2·K·valid_len words). The softmax of beam k
// runs in warp k with shuffles only (K ≤ 8 = warps). PV: 16 threads
// cover one pair's 64 V bytes (char4 each), 16 pairs in flight, each
// pair's bytes accumulated into every owning beam; partial sums are
// combined by warp shuffles and one pass through shared memory. Later
// work: 4-byte K loads along t where a lane's run allows, and more
// blocks per (b, h) (B·H = 160 at B = 8 does not fill the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int D = 64;                 // head dim
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BEAMS = 8;
constexpr int V_LANES = D / 4;        // threads per pair in PV (char4 each)
constexpr int V_PAIRS = THREADS / V_LANES;  // pairs in flight per PV pass
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

static_assert(MAX_BEAMS <= WARPS, "one warp per beam in the softmax");
static_assert(V_LANES == 16, "PV reduction pairs lanes l and l^16");

__global__ void __launch_bounds__(THREADS)
self_attention_int8_lanes_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, K, 64)
                                 const int8_t* __restrict__ kp,         // (B, H·64, K·T)
                                 const __nv_bfloat16* __restrict__ ks,  // (B, H, K·T)
                                 const int8_t* __restrict__ vp,         // (B, K·T, H·64)
                                 const __nv_bfloat16* __restrict__ vs,  // (B, H, K·T)
                                 const int* __restrict__ lane_map,      // (B, K, T)
                                 __nv_bfloat16* __restrict__ o,         // (B, H, K, 64)
                                 int n_head, int beams, int t_len, int valid_len) {
    extern __shared__ int smem[];
    int* lane_s = smem;                                           // (K, valid_len)
    float* w_s = reinterpret_cast<float*>(smem + beams * valid_len);  // (K, valid_len)
    __shared__ float q_s[MAX_BEAMS][D];
    __shared__ float part[WARPS][MAX_BEAMS][D];

    const int bh = blockIdx.x;
    const int b = bh / n_head;
    const int h = bh % n_head;
    const size_t kt = (size_t)beams * t_len;
    const size_t width = (size_t)n_head * D;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int n_items = beams * valid_len;            // (lane, t) pairs, lane-major

    for (int i = tid; i < MAX_BEAMS * D; i += THREADS) {
        const int k = i / D;
        q_s[k][i % D] = k < beams ? __bfloat162float(q[(size_t)bh * beams * D + i]) : 0.0f;
    }
    for (int i = tid; i < n_items; i += THREADS) {
        const int k = i / valid_len;
        const int t = i % valid_len;
        lane_s[i] = lane_map[((size_t)b * beams + k) * t_len + t];
    }
    __syncthreads();

    // scores: each owned pair read once, scored for all its owners
    const int8_t* kh = kp + ((size_t)b * width + (size_t)h * D) * kt;  // row h·64
    const __nv_bfloat16* ksh = ks + (size_t)bh * kt;
    const __nv_bfloat16* vsh = vs + (size_t)bh * kt;
    for (int i = tid; i < n_items; i += THREADS) {
        const int l = i / valid_len;
        const int t = i % valid_len;
        unsigned owners = 0;
        for (int k = 0; k < beams; ++k)
            owners |= (unsigned)(lane_s[k * valid_len + t] == l) << k;
        if (!owners) continue;
        const size_t j = (size_t)l * t_len + t;
        float s[MAX_BEAMS];
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k) s[k] = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
            const float kv = (float)kh[(size_t)d * kt + j];
#pragma unroll
            for (int k = 0; k < MAX_BEAMS; ++k) s[k] = fmaf(q_s[k][d], kv, s[k]);
        }
        const float sc = __bfloat162float(ksh[j]) * SCALE_LOG2;
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k)
            if ((owners >> k) & 1u) w_s[k * valid_len + t] = s[k] * sc;
    }
    __syncthreads();

    // softmax of beam k in warp k; weights × vs rounded to bf16 before PV
    if (warp < beams) {
        float* row = w_s + warp * valid_len;
        const int* lrow = lane_s + warp * valid_len;
        float mx = -INFINITY;
        for (int t = lane; t < valid_len; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.0f;
        for (int t = lane; t < valid_len; t += 32) {
            const float p = exp2f(row[t] - mx);
            row[t] = p;
            sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float inv = 1.0f / sum;
        for (int t = lane; t < valid_len; t += 32) {
            const float v_scale = __bfloat162float(vsh[(size_t)lrow[t] * t_len + t]);
            row[t] = __bfloat162float(__float2bfloat16(row[t] * inv * v_scale));
        }
    }
    __syncthreads();

    // PV: thread (pair stream g, dims 4·dq..4·dq+3) of head h's V columns
    const int dq = tid % V_LANES;
    const int g = tid / V_LANES;
    const int8_t* vb = vp + (size_t)b * kt * width + (size_t)h * D + dq * 4;
    float acc[MAX_BEAMS][4];
#pragma unroll
    for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[k][jj] = 0.0f;
    for (int i = g; i < n_items; i += V_PAIRS) {
        const int l = i / valid_len;
        const int t = i % valid_len;
        float wk[MAX_BEAMS];
        bool owned = false;
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k) {
            const bool own = k < beams && lane_s[k * valid_len + t] == l;
            wk[k] = own ? w_s[k * valid_len + t] : 0.0f;
            owned |= own;
        }
        if (!owned) continue;
        const char4 vv =
            *reinterpret_cast<const char4*>(vb + ((size_t)l * t_len + t) * width);
        const float v4[4] = {(float)vv.x, (float)vv.y, (float)vv.z, (float)vv.w};
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[k][jj] = fmaf(wk[k], v4[jj], acc[k][jj]);
    }
#pragma unroll
    for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
            acc[k][jj] += __shfl_xor_sync(0xffffffffu, acc[k][jj], 16);
    if (lane < V_LANES) {
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) part[warp][k][dq * 4 + jj] = acc[k][jj];
    }
    __syncthreads();
    for (int i = tid; i < beams * D; i += THREADS) {
        const int k = i / D;
        const int d = i % D;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += part[w][k][d];
        o[(size_t)bh * beams * D + i] = __float2bfloat16(s);
    }
}

}  // namespace

// q, o: (batch, n_head, beams, 64) bf16; kp: (batch, n_head·64,
// beams·t_len) int8; vp: (batch, beams·t_len, n_head·64) int8, 4-byte
// aligned; ks, vs: (batch, n_head, beams·t_len) bf16; lane_map: (batch,
// beams, t_len) int32 with values in [0, beams). All contiguous;
// 1 ≤ beams ≤ 8; 1 ≤ valid_len ≤ t_len. Returns cudaGetLastError()
// after the launch.
extern "C" int tww_self_attention_int8_lanes(const void* q, const void* kp, const void* ks,
                                             const void* vp, const void* vs,
                                             const void* lane_map, void* o, int batch,
                                             int n_head, int beams, int t_len,
                                             int valid_len, void* stream) {
    const size_t smem = 2 * (size_t)beams * valid_len * sizeof(float);
    // ~18 KB of static shared memory: above 24 KB of dynamic the 48 KB
    // default is not enough
    if (smem > 24 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            self_attention_int8_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    self_attention_int8_lanes_kernel<<<batch * n_head, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kp),
        static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(vp),
        static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(lane_map),
        static_cast<__nv_bfloat16*>(o), n_head, beams, t_len, valid_len);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_self_attention_int8_lanes_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
