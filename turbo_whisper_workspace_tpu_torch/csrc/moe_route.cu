// The DeepSeek-V3 router (sigmoid scores, a selection-only bias, top-k)
// for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU counterpart: the JAX package runs no mixture of experts. It
// computes, for each token row of h, what models/deepseek_v3.py's plain
// router computes in about ten library launches: s = sigmoid(h · Wᵀ) in
// f32 (h bf16, W (E, d) bf16, the checkpoint's own layout), the top_k
// experts of s + bias (largest first), their weights s / (Σ s + 1e-20) ·
// scale (or s · scale without the normalization), then the n_shared
// shared experts' ids at weight 1. At the decode step it is one launch a
// layer in place of those ten. Where the caller gives a log (B, S, top_k)
// int32, the chosen ids of row b·t + i are also written at position pos + i
// of batch row b (pos read from device memory or given, clamped to [0, S −
// t]): the served expert choices, kept without a launch of their own.
//
// What bounds it: at one row, W's 256 KB (2048 × 64 bf16), read from HBM
// (a decode step streams ~10 GB of weights between two reads of it): 0.08
// µs of bytes, but far more for one SM. Design: one thread-block cluster of
// R ≤ 8 blocks a row, each holding E / R experts' rows of W (one warp an
// expert, 16-byte loads along d, the row of h staged in shared memory as
// f32); each block sends its experts' scores into rank 0's shared memory,
// and rank 0's first warp picks the top_k by k rounds of a warp argmax
// (ties to the lower id) and writes ids and weights.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_EXPERTS = 256;
constexpr int MAX_TOP_K = 16;

__global__ void __launch_bounds__(THREADS)
moe_route_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, const long long* __restrict__ shared,
                 long long* __restrict__ ids, float* __restrict__ weights,
                 int* __restrict__ log, const long long* __restrict__ pos_at, int pos_i,
                 int t_rows, int s_len, int d, int e, int top_k, int n_shared, int norm,
                 float scale) {
    extern __shared__ float x_s[];                   // the row of h, f32 [d]
    __shared__ float score[MAX_EXPERTS];             // rank 0's: every expert's
    __shared__ float choice[MAX_EXPERTS];
    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int t = blockIdx.x / ranks;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const __nv_bfloat16* x = h + (long long)t * d;
    for (int i = tid; i < d; i += THREADS) x_s[i] = __bfloat162float(x[i]);
    cluster.sync();                                  // every block has started, and staged h
    const int per = (e + ranks - 1) / ranks;         // experts a block
    float* score0 = cluster.map_shared_rank(score, 0);
    float* choice0 = cluster.map_shared_rank(choice, 0);
    for (int ex = rank * per + warp; ex < min(e, (rank + 1) * per); ex += WARPS) {
        const __nv_bfloat16* wr = w + (long long)ex * d;
        float acc = 0.0f;
        for (int i = 8 * lane; i < d; i += 8 * 32) {   // 8 bf16 a load
            const uint4 v = *reinterpret_cast<const uint4*>(wr + i);
            const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(p[j]);
                acc = fmaf(x_s[i + 2 * j], f.x, acc);
                acc = fmaf(x_s[i + 2 * j + 1], f.y, acc);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) {
            const float sc = 1.0f / (1.0f + expf(-acc));
            score0[ex] = sc;
            choice0[ex] = sc + bias[ex];
        }
    }
    cluster.sync();                                  // every score is in rank 0
    if (rank != 0 || warp != 0) return;
    unsigned taken = 0;                              // bit j: expert lane + 32·j picked
    long long* row_ids = ids + (long long)t * (top_k + n_shared);
    float* row_w = weights + (long long)t * (top_k + n_shared);
    float picked[MAX_TOP_K];
    int picked_id[MAX_TOP_K];
    for (int r = 0; r < top_k; ++r) {
        float best = -INFINITY;
        int best_id = 0x7fffffff;
        for (int j = 0; lane + 32 * j < e; ++j) {
            const int id = lane + 32 * j;
            if (!(taken >> j & 1u) && (choice[id] > best || (choice[id] == best && id < best_id))) {
                best = choice[id];
                best_id = id;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, best_id, off);
            if (ob > best || (ob == best && oi < best_id)) {
                best = ob;
                best_id = oi;
            }
        }
        if (best_id % 32 == lane) taken |= 1u << (best_id / 32);
        picked_id[r] = best_id;
        picked[r] = score[best_id];
    }
    if (lane != 0) return;
    float sum = 0.0f;
    for (int r = 0; r < top_k; ++r) sum += picked[r];
    const float denom = sum + 1e-20f;
    for (int r = 0; r < top_k; ++r) {
        row_ids[r] = picked_id[r];
        row_w[r] = (norm ? picked[r] / denom : picked[r]) * scale;
    }
    for (int j = 0; j < n_shared; ++j) {
        row_ids[top_k + j] = shared[j];
        row_w[top_k + j] = 1.0f;
    }
    if (log != nullptr) {
        long long p = pos_at != nullptr ? *pos_at : pos_i;
        p = p < 0 ? 0 : (p > s_len - t_rows ? s_len - t_rows : p);
        int* at = log + ((long long)(t / t_rows) * s_len + p + t % t_rows) * top_k;
        for (int r = 0; r < top_k; ++r) at[r] = picked_id[r];
    }
}

}  // namespace

// h (rows, d) bf16 dense; w (e, d) bf16, 16-byte aligned, d a multiple of
// 8; bias (e,) f32; shared (n_shared,) int64; ids (rows, top_k + n_shared)
// int64 and weights (rows, top_k + n_shared) f32 written. 1 ≤ e ≤ 256, 1 ≤
// top_k ≤ min(16, e), d ≤ 16384. log: null, or (rows / t_rows, s_len,
// top_k) int32, written at the rows' positions (pos at pos_at in device
// memory, or the host int pos when pos_at is null). Returns
// cudaGetLastError() after the launch (or the launch's own error).
extern "C" int tww_moe_route(const void* h, const void* w, const void* bias, const void* shared,
                             void* ids, void* weights, void* log, const void* pos_at, int pos,
                             int t_rows, int s_len, int rows, int d, int e, int top_k,
                             int n_shared, int norm, float scale, void* stream) {
    if (rows < 1 || d < 8 || d % 8 || d > 16384 || e < 1 || e > MAX_EXPERTS || top_k < 1 ||
        top_k > MAX_TOP_K || top_k > e || n_shared < 0 ||
        (log != nullptr && (t_rows < 1 || rows % t_rows || t_rows > s_len)))
        return (int)cudaErrorInvalidValue;
    int ranks = (e + 7) / 8;                         // about 8 experts a block, one a warp
    ranks = ranks < MAX_RANKS ? ranks : MAX_RANKS;
    const cudaError_t err = launch_clusters(
        moe_route_kernel, rows * ranks, THREADS, ranks, (size_t)d * sizeof(float),
        2 * MAX_EXPERTS * sizeof(float), (cudaStream_t)stream,
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const long long*>(shared),
        static_cast<long long*>(ids), static_cast<float*>(weights), static_cast<int*>(log),
        static_cast<const long long*>(pos_at), pos, t_rows, s_len, d, e, top_k, n_shared, norm,
        scale);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* tww_moe_route_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
