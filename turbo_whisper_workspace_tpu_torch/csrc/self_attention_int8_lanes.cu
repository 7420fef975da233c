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
//   w   = exp2(s - max) · (1 / Σ)                         (f32)
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
// pairs are about valid_len, far fewer than K·valid_len: at B = 8,
// H = 20 a few MB, under a microsecond at the HBM rate. What bounds it
// in practice: the K panel's layout spreads a pair's 64 K bytes over 64
// rows K·T bytes apart, 64 separate 32-byte sectors (7 MB of sectors for
// 1.2 MB of owned K bytes at valid_len 115), read in random order; and
// the chain lane_map → owned pairs → K/V bytes → scores → softmax → P·V,
// each link a round trip or a barrier.
//
// Design: one thread-block cluster of C ≤ 8 blocks per (b, h), launched
// with cudaLaunchKernelEx; rank r owns positions [r·S, (r+1)·S) of the
// cache's T. The plan is make_plan below (about 32 positions a rank),
// mirrored by ops/attention.py:lanes_plan, and depends on T only:
// valid_len is a device int32, as the TPU kernel takes it, which the
// beam step that a CUDA graph replays moves on the device. Each block
// reads it on entry and takes positions [r·S, min((r+1)·S, valid_len));
// a rank wholly past it owns no pair, publishes −inf and 0 to the
// softmax and still reaches the three cluster barriers. At the beam
// path's T = 227 the plan is C = 8, S = 29 (1280 blocks at B = 8,
// H = 20), so at valid_len 115 half the ranks have nothing to do. A
// cluster, not one block looping over chunks of pairs: the K = 8,
// T = 448 case (3584 pairs, 473 KB) fits the cluster's shared memory at
// once (448 pairs a rank), and the ranks' loads are all in flight
// together.
//   Owned pairs: each rank reads its lane_map[b, :, slice] and builds the
// list of (lane, t) pairs some beam owns with their owner masks (warp
// ballots, a prefix sum over the warps), lane-major: neighbouring pairs
// of the list are then mostly neighbouring bytes of one K panel row, so
// a warp's K loads fall in few sectors. Ownership is the same for every
// head of item b; each (b, h) rebuilds it, which costs one lane_map read
// a block.
//   Loads, all issued before any compute: each pair's V row (64 bytes at
// a 16-byte-aligned offset: H·64 = 1280) as four 16-byte cp.async; its
// K column as 64 single-byte loads (up to 32 a thread in flight),
// packed 4 rows a word into shared memory. The K panel's row stride is
// K·T bytes, odd at T = 227, so a pair's column is 64 bytes in 64 rows.
// Under beam ancestry a lane's owned positions form runs of one or two:
// 16-byte copies of each lane's runs would touch the same sectors and
// read bytes no beam owns besides. Byte loads read no byte outside the
// panel. The pair's bf16 scales ride with its first K word.
//   Scores: thread per pair, for every beam that owns it at once (f32 FMA
// on bytes made floats by a byte permute into 2^23's mantissa), kept per
// (beam, t): each beam owns exactly one pair at each position, so the
// softmax runs over the rank's positions with nothing masked.
//   Softmax across the cluster: each rank publishes per beam its (m_r,
// Σ exp2(s − m_r)); after one cluster barrier every rank reads all C
// pairs at once (one lane per rank, distributed shared memory), forms M
// and Σ = Σ_r sum_r · exp2(m_r − M) in rank order and rounds
// w = bf16(exp2(s − M) · (1/Σ) · vs) from its stored scores: the
// rounding point of the TPU kernel, only Σ's f32 order differs. P·V
// reads each pair's weight for every owner from the (beam, t) array.
//   P·V: each rank's f32 partial (K beams × 64) goes to shared memory;
// after a second barrier rank r sums output dims [64r/C, 64(r+1)/C) of
// every beam over the C ranks in rank order. The per-warp partials reuse
// the packed K columns' shared memory (dead once the scores are done):
// shared memory is what limits the blocks resident on an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;                 // head dim
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BEAMS = 8;
constexpr int T_PER_RANK = 32;        // the plan's target slice before rounding
constexpr int MAX_T = 1024;           // positions a cluster holds (S ≤ 128)
constexpr int GATHER = 8;             // K items a thread has in flight
constexpr int PV_STREAMS = THREADS / 16;   // pair streams in P·V
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;
// the kernel's static shared memory (q, the rank's P·V partial, the softmax pair)
constexpr size_t STATIC_SMEM = sizeof(float) * (2 * MAX_BEAMS * D + 2 * MAX_BEAMS) +
                               sizeof(int) * WARPS;

struct Plan {
    int ranks, slice;
};

// mirrored by ops/attention.py:lanes_plan; t_len is the cache length
Plan make_plan(int t_len) {
    int ranks = (t_len + T_PER_RANK - 1) / T_PER_RANK;
    ranks = ranks < 1 ? 1 : (ranks > MAX_RANKS ? MAX_RANKS : ranks);
    const int slice = (t_len + ranks - 1) / ranks;
    return {(t_len + slice - 1) / slice, slice};
}

// the packed K columns of the pairs, which the per-warp P·V partials
// (WARPS, K, 64) f32 reuse once the scores are done
__host__ __device__ __forceinline__ size_t k_region_bytes(int beams, int slice) {
    const size_t k_bytes = (size_t)beams * slice * D;
    const size_t part_bytes = sizeof(float) * WARPS * beams * D;
    return k_bytes > part_bytes ? k_bytes : part_bytes;
}

// the dynamic shared memory of one block (layout in the kernel)
size_t smem_bytes(int beams, int slice) {
    const size_t pairs = (size_t)beams * slice;
    return pairs * (D + 3 * sizeof(float)) + k_region_bytes(beams, slice) +
           3 * sizeof(float) * (size_t)beams * slice;
}

// a pair: its position in the slice, its lane and its owner mask
__device__ __forceinline__ int pair_t(int info) { return info & 0xffff; }
__device__ __forceinline__ int pair_lane(int info) { return (info >> 16) & 0xf; }
__device__ __forceinline__ unsigned pair_owners(int info) { return (unsigned)info >> 20; }

__global__ void __launch_bounds__(THREADS)
self_attention_int8_lanes_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, K, 64)
                                 const int8_t* __restrict__ kp,         // (B, H·64, K·T)
                                 const __nv_bfloat16* __restrict__ ks,  // (B, H, K·T)
                                 const int8_t* __restrict__ vp,         // (B, K·T, H·64)
                                 const __nv_bfloat16* __restrict__ vs,  // (B, H, K·T)
                                 const int* __restrict__ lane_map,      // (B, K, T)
                                 __nv_bfloat16* __restrict__ o,         // (B, H, K, 64)
                                 int n_head, int beams, int t_len,
                                 const int* __restrict__ valid_len_at,  // device int32
                                 int slice) {
    // P = K·S pairs at most; arrays indexed by pair use the rank's count np
    extern __shared__ __align__(16) uint8_t smem[];
    const int max_pairs = beams * slice;
    int8_t* v_c = reinterpret_cast<int8_t*>(smem);                         // (P, 64)
    unsigned* k_c = reinterpret_cast<unsigned*>(v_c + (size_t)max_pairs * D);  // (16, np) words
    float* part = reinterpret_cast<float*>(k_c);                 // then (WARPS, K, 64) P·V partials
    float* ksc = reinterpret_cast<float*>(v_c + (size_t)max_pairs * D +
                                          k_region_bytes(beams, slice));  // (P) ks · scale
    float* vsc = ksc + max_pairs;                                          // (P)
    int* pairs = reinterpret_cast<int*>(vsc + max_pairs);                  // (P)
    int* lane_s = pairs + max_pairs;                                       // (K, S)
    float* w_s = reinterpret_cast<float*>(lane_s + beams * slice);         // (K, S) scores, weights
    float* vs_s = w_s + beams * slice;                                     // (K, S) vs of its pair
    __shared__ __align__(16) float q_s[MAX_BEAMS][D];
    __shared__ float opart[MAX_BEAMS][D];
    __shared__ float pmax[MAX_BEAMS], psum[MAX_BEAMS];
    __shared__ int warp_count[WARPS];

    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int bh = blockIdx.x / ranks;
    const int b = bh / n_head;
    const int h = bh % n_head;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const size_t kt = (size_t)beams * t_len;
    const size_t width = (size_t)n_head * D;
    const int t0 = rank * slice;
    // clamped to [1, T]: no value reads outside the cache
    const int valid_len = min(max(__ldg(valid_len_at), 1), t_len);
    const int nt = max(0, min(slice, valid_len - t0));   // this rank's positions

    for (int i = tid; i < MAX_BEAMS * D; i += THREADS) {
        const int k = i / D;
        q_s[k][i % D] = k < beams ? __bfloat162float(q[(size_t)bh * beams * D + i]) : 0.0f;
    }
    for (int i = tid; i < beams * nt; i += THREADS) {
        const int k = i / nt;
        const int t = i % nt;
        lane_s[k * slice + t] = lane_map[((size_t)b * beams + k) * t_len + t0 + t];
    }
    __syncthreads();

    // the owned pairs, lane-major: item (l, t) with its owner mask, kept
    // where the mask is not empty, at its rank among the kept items
    int np = 0;
    for (int i0 = 0; i0 < nt * beams; i0 += THREADS) {
        const int i = i0 + tid;
        unsigned owners = 0;
        int t = 0, l = 0;
        if (i < nt * beams) {
            l = i / nt;
            t = i % nt;
            for (int k = 0; k < beams; ++k)
                owners |= (unsigned)(lane_s[k * slice + t] == l) << k;
        }
        const unsigned kept = __ballot_sync(0xffffffffu, owners != 0);
        if (lane == 0) warp_count[warp] = __popc(kept);
        __syncthreads();
        int at = np, total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            at += w < warp ? warp_count[w] : 0;
            total += warp_count[w];
        }
        if (owners) pairs[at + __popc(kept & ((1u << lane) - 1u))] = t | l << 16 | owners << 20;
        np += total;
        __syncthreads();   // warp_count is rewritten by the next round
    }

    // every load of the owned pairs before any compute: V rows by
    // cp.async, K columns and scales by loads in flight together
    {
        const int8_t* vb = vp + (size_t)b * kt * width + (size_t)h * D;
        const uint32_t v_addr = (uint32_t)__cvta_generic_to_shared(v_c);
        for (int i = tid; i < np * 4; i += THREADS) {
            const int info = pairs[i / 4];
            const size_t j = (size_t)pair_lane(info) * t_len + t0 + pair_t(info);
            cp_async16(v_addr + (i / 4) * D + 16 * (i % 4), vb + j * width + 16 * (i % 4));
        }
        cp_async_commit();
        const int8_t* kb = kp + ((size_t)b * width + (size_t)h * D) * kt;   // row h·64
        const __nv_bfloat16* ksh = ks + (size_t)bh * kt;
        const __nv_bfloat16* vsh = vs + (size_t)bh * kt;
        for (int i0 = 0; i0 < np * (D / 4); i0 += THREADS * GATHER) {
            // item i: rows 4w..4w+3 of pair p's column (w = i / np, p = i % np)
            unsigned word[GATHER];
            float kscale[GATHER], vscale[GATHER];
#pragma unroll
            for (int u = 0; u < GATHER; ++u) {
                const int i = i0 + u * THREADS + tid;
                word[u] = 0;
                kscale[u] = vscale[u] = 0.0f;
                if (i < np * (D / 4)) {
                    const int p = i % np;
                    const int w = i / np;
                    const int info = pairs[p];
                    const size_t j = (size_t)pair_lane(info) * t_len + t0 + pair_t(info);
                    const int8_t* col = kb + (size_t)(4 * w) * kt + j;
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        word[u] |= (unsigned)(uint8_t)__ldg(col + r * kt) << (8 * r);
                    if (w == 0) {
                        kscale[u] = __bfloat162float(ksh[j]);
                        vscale[u] = __bfloat162float(vsh[j]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < GATHER; ++u) {
                const int i = i0 + u * THREADS + tid;
                if (i < np * (D / 4)) {
                    k_c[i] = word[u];               // word w of pair p at w·np + p
                    if (i < np) {
                        ksc[i] = kscale[u] * SCALE_LOG2;
                        vsc[i] = vscale[u];
                    }
                }
            }
        }
    }
    __syncthreads();

    // scores: thread per pair, for every beam that owns it, at (beam, t)
    for (int p = tid; p < np; p += THREADS) {
        float s[MAX_BEAMS];
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k) s[k] = 0.0f;
#pragma unroll 4
        for (int w = 0; w < D / 4; ++w) {
            float k4[4];
            bytes_to_float(k_c[w * np + p], k4);
#pragma unroll
            for (int k = 0; k < MAX_BEAMS; ++k) {
                if (k < beams) {
                    const float4 qv = *reinterpret_cast<const float4*>(&q_s[k][4 * w]);
                    s[k] = fmaf(qv.x, k4[0], s[k]);
                    s[k] = fmaf(qv.y, k4[1], s[k]);
                    s[k] = fmaf(qv.z, k4[2], s[k]);
                    s[k] = fmaf(qv.w, k4[3], s[k]);
                }
            }
        }
        const int info = pairs[p];
        const unsigned owners = pair_owners(info);
        const float sc = ksc[p];
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k) {
            if (k < beams && (owners >> k) & 1u) {
                w_s[k * slice + pair_t(info)] = s[k] * sc;
                vs_s[k * slice + pair_t(info)] = vsc[p];
            }
        }
    }
    __syncthreads();

    // each beam's max m_r and Σ exp2(s − m_r) over this rank's positions,
    // published for the cluster (−inf and 0 for a rank past valid_len)
    for (int k = warp; k < beams; k += WARPS) {
        float mx = -INFINITY;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, w_s[k * slice + t]);
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int t = lane; t < nt; t += 32) sum += exp2f(w_s[k * slice + t] - mx);
        sum = warp_sum(sum);
        if (lane == 0) {
            pmax[k] = mx;
            psum[k] = sum;
        }
    }
    cluster.sync();
    // the global M (rank 0 holds position 0, which every beam owns) and
    // Σ = Σ_r sum_r · exp2(m_r − M) in rank order; then the weights
    // bf16(exp2(s − M) · (1/Σ) · vs)
    for (int k = warp; k < beams; k += WARPS) {
        float mc = -INFINITY, sc_c = 0.0f;
        if (lane < ranks) {                       // the remote reads in parallel
            mc = *cluster.map_shared_rank(pmax + k, lane);
            sc_c = *cluster.map_shared_rank(psum + k, lane);
        }
        const float m = warp_max(mc);
        const float term = sc_c * exp2f(mc - m);
        float sum = 0.0f;
        for (int c = 0; c < ranks; ++c) sum += __shfl_sync(0xffffffffu, term, c);
        const float inv = 1.0f / sum;
        for (int t = lane; t < nt; t += 32)
            w_s[k * slice + t] = __bfloat162float(
                __float2bfloat16(exp2f(w_s[k * slice + t] - m) * inv * vs_s[k * slice + t]));
    }
    cp_async_wait<0>();                           // this thread's V copies landed
    __syncthreads();

    // P·V: thread (pair stream g, dims 4·dq..4·dq+3)
    {
        const int dq = tid % 16;
        const int g = tid / 16;
        float acc[MAX_BEAMS][4];
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[k][j] = 0.0f;
        for (int p = g; p < np; p += PV_STREAMS) {
            float v4[4];
            bytes_to_float(*reinterpret_cast<const uint32_t*>(v_c + p * D + 4 * dq), v4);
            const int info = pairs[p];
            const unsigned owners = pair_owners(info);
#pragma unroll
            for (int k = 0; k < MAX_BEAMS; ++k) {
                if (k < beams) {
                    const float wk = (owners >> k) & 1u ? w_s[k * slice + pair_t(info)] : 0.0f;
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(wk, v4[j], acc[k][j]);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], 16);
        if (lane < 16) {
#pragma unroll
            for (int k = 0; k < MAX_BEAMS; ++k)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (k < beams) part[(warp * beams + k) * D + 4 * dq + j] = acc[k][j];
        }
    }
    __syncthreads();
    for (int i = tid; i < beams * D; i += THREADS) {
        const int k = i / D;
        const int d = i % D;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[(w * beams + k) * D + d];
        opart[k][d] = sum;
    }
    cluster.sync();
    // this rank's output dims of every beam, summed over the ranks in
    // rank order
    const int d0 = rank * D / ranks;
    const int nd = (rank + 1) * D / ranks - d0;
    for (int i = tid; i < beams * nd; i += THREADS) {
        const int k = i / nd;
        const int d = d0 + i % nd;
        float v[MAX_RANKS];
#pragma unroll
        for (int c = 0; c < MAX_RANKS; ++c)
            v[c] = c < ranks ? *cluster.map_shared_rank(&opart[k][d], c) : 0.0f;
        float sum = v[0];
#pragma unroll
        for (int c = 1; c < MAX_RANKS; ++c) sum += v[c];
        o[((size_t)bh * beams + k) * D + d] = __float2bfloat16(sum);
    }
    cluster.sync();      // no block leaves while another still reads its shared memory
}

}  // namespace

// q, o: (batch, n_head, beams, 64) bf16; kp: (batch, n_head·64,
// beams·t_len) int8; vp: (batch, beams·t_len, n_head·64) int8, 16-byte
// aligned; ks, vs: (batch, n_head, beams·t_len) bf16; lane_map: (batch,
// beams, t_len) int32 with values in [0, beams). All contiguous;
// 1 ≤ beams ≤ 8; 1 ≤ t_len ≤ 1024. valid_len: one int32 in device
// memory, read by the kernel (clamped to [1, t_len]). Returns
// cudaGetLastError() after the launch (or the launch's own error).
extern "C" int tww_self_attention_int8_lanes(const void* q, const void* kp, const void* ks,
                                             const void* vp, const void* vs,
                                             const void* lane_map, void* o, int batch,
                                             int n_head, int beams, int t_len,
                                             const void* valid_len, void* stream) {
    if (beams < 1 || beams > MAX_BEAMS || t_len < 1 || t_len > MAX_T)
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(t_len);
    const cudaError_t err = launch_clusters(
        self_attention_int8_lanes_kernel, batch * n_head * p.ranks, THREADS, p.ranks,
        smem_bytes(beams, p.slice), STATIC_SMEM, (cudaStream_t)stream,
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kp),
        static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(vp),
        static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(lane_map),
        static_cast<__nv_bfloat16*>(o), n_head, beams, t_len,
        static_cast<const int*>(valid_len), p.slice);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* tww_self_attention_int8_lanes_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
