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
// operations per byte, so it is bound by HBM (3.35 TB/s): 12.1 MB, 3.7 µs
// at valid_len 115 for the beam path's 800 (b, h). Only keys t <
// valid_len need be read. valid_len is a device int32, as the TPU
// kernel's scalar prefetch takes it: the beam step that a CUDA graph
// replays moves it on the device, so the launch (grid, shared memory)
// depends on the cache length T only, and each block reads valid_len on
// entry and sizes its copies and loops from it.
//
// Design: the work is tiny (~6 M FMAs), so the time is a chain of
// latencies; the kernel puts every byte of a (b, h) in flight at entry and
// then runs one short dependent chain. One block of 128 threads per
// (b, h) takes all Tq query rows. At entry thread 0 issues two 1D bulk
// copies (cp.async.bulk, the TMA's linear mode) of the K slab and the V
// slab, each one contiguous run of valid_len × 64 bytes, each completing
// on its own mbarrier, so the scores start when K lands and P·V when V
// lands; meanwhile the threads take the ks and vs rows, which sit at
// b·h·T·2 bytes and are not 16-byte aligned, as 16-byte cp.async copies
// of their aligned interior and plain 2-byte loads of the edges (at most
// 7 elements at each end), placed at the same offset modulo 16 in shared
// memory, and each lane its 16 dims of q into registers. Scores: four
// lanes a key, each reading 16 bytes of K from shared memory (a warp
// reads 512 contiguous bytes: conflict-free), summed by two shuffles; the
// row's max and sum take a warp shuffle tree and one pass through shared
// memory each. P·V: four lanes a key again, 16 V bytes and 16 f32 sums a
// lane, the weight bf16(w · vs) formed by each lane from the shared
// probabilities; the 8 keys of a warp meet by shuffles and the 4 warps in
// shared memory. int8 bytes become floats exactly by the 2^23 trick
// (cluster_attention.cuh). Keys t ≥ valid_len are never copied or read.
// Shared memory is laid out for all T keys, ~136 bytes a key and 1.1 KB
// (32.1 KB with the card's 1 KB a block at T = 227, 7 blocks an SM;
// 61.6 KB at T = 448, 3), so the beam path's 800 blocks run in one wave
// at T = 227 and in three at T = 448 whatever valid_len is; only the
// first valid_len rows of it are filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster_attention.cuh"

namespace {

constexpr int D = 64;                       // head dim
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KEY_LANES = 4;                // lanes a key, 16 bytes each
constexpr int KEYS = THREADS / KEY_LANES;   // keys a pass of the block
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

// arrive once on `bar`, expecting `bytes` more to land on it
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// wait for phase 0 of `bar`; a copy that never lands traps (a launch
// error) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred P1;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], 0;\n"
            "selp.u32 %0, 1, 0, P1;\n}\n" : "=r"(done) : "r"(bar) : "memory");
        if (done) return;
        if (spins == (1u << 24)) __trap();
    }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A scale row of n bf16 at global address g into the shared buffer at s
// (16-byte aligned), element i landing at s + g % 16 + 2i: 16-byte
// cp.async copies of the row's aligned interior, issued by the block's
// threads, and plain loads of its edges, by lane e of warp `edge_warp`
// (head elements at lanes 0..15, tail elements at 16..31).
__device__ __forceinline__ void copy_scales(unsigned char* s, const __nv_bfloat16* row, int n,
                                            int edge_warp) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(row);
    const uintptr_t base = g & ~uintptr_t(15);
    const uintptr_t lo = (g + 15) & ~uintptr_t(15);          // the interior [lo, hi)
    const uintptr_t hi = (g + 2 * (uintptr_t)n) & ~uintptr_t(15);
    for (uintptr_t c = lo + 16 * threadIdx.x; c + 16 <= hi; c += 16 * THREADS)
        cp_async16(smem_u32(s + (c - base)), reinterpret_cast<const void*>(c));
    const int head = lo < hi ? (int)(lo - g) / 2 : n;        // elements before lo
    const int tail = lo < hi ? (int)(hi - g) / 2 : n;        // first element at or past hi
    const int lane = threadIdx.x % 32;
    if ((int)threadIdx.x / 32 != edge_warp) return;
    const int i = lane < 16 ? lane : tail + lane - 16;
    if ((lane < 16 && i < head) || (lane >= 16 && i < n))
        reinterpret_cast<__nv_bfloat16*>(s + (g - base))[i] = row[i];
}

__device__ __forceinline__ float scale_at(const unsigned char* s, int pad, int t) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(s + pad)[t]);
}

// bytes a scale buffer takes: the row, its offset modulo 16, rounded up
__host__ __device__ __forceinline__ int scale_bytes(int n) { return (2 * n + 30) / 16 * 16; }

__global__ void __launch_bounds__(THREADS)
self_attention_int8_kernel(const __nv_bfloat16* __restrict__ q,   // (B·H, Tq, 64)
                           const int8_t* __restrict__ kq,         // (B·H, T, 64)
                           const __nv_bfloat16* __restrict__ ks,  // (B·H, T)
                           const int8_t* __restrict__ vq,         // (B·H, T, 64)
                           const __nv_bfloat16* __restrict__ vs,  // (B·H, T)
                           __nv_bfloat16* __restrict__ o,         // (B·H, Tq, 64)
                           int tq, int t_len,
                           const int* __restrict__ valid_len_at) {  // device int32
    // K slab, V slab (T × 64 each), ks, vs, then the row's f32 scores /
    // probabilities (T); the first valid_len rows of each are used
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t bars[2];                 // K landed, V landed
    __shared__ float red[2][WARPS];
    __shared__ float part[WARPS][D];

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int sub = tid % KEY_LANES;  // this lane's 16 dims: 16·sub ..
    const int key = tid / KEY_LANES;  // its key of each pass
    const size_t bh = blockIdx.x;
    // clamped to [1, T]: no value reads outside the cache
    const int valid_len = min(max(__ldg(valid_len_at), 1), t_len);
    const int slab = valid_len * D;   // bytes of the K (and V) rows copied
    unsigned char* k_s = smem;
    unsigned char* v_s = smem + t_len * D;
    unsigned char* ks_s = smem + 2 * t_len * D;
    unsigned char* vs_s = ks_s + scale_bytes(t_len);
    float* p_s = reinterpret_cast<float*>(vs_s + scale_bytes(t_len));
    const __nv_bfloat16* ks_row = ks + bh * t_len;
    const __nv_bfloat16* vs_row = vs + bh * t_len;
    const int ks_pad = (int)(reinterpret_cast<uintptr_t>(ks_row) % 16);
    const int vs_pad = (int)(reinterpret_cast<uintptr_t>(vs_row) % 16);

    // every copy of the block in flight at once
    if (tid == 0) {
        mbar_init(smem_u32(&bars[0]));
        mbar_init(smem_u32(&bars[1]));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(smem_u32(&bars[0]), slab);
        bulk_copy(smem_u32(k_s), kq + bh * t_len * D, slab, smem_u32(&bars[0]));
        mbar_expect(smem_u32(&bars[1]), slab);
        bulk_copy(smem_u32(v_s), vq + bh * t_len * D, slab, smem_u32(&bars[1]));
    }
    copy_scales(ks_s, ks_row, valid_len, 0);
    copy_scales(vs_s, vs_row, valid_len, 1);
    cp_async_commit();
    float qv[16];                     // this lane's 16 dims of the query row
#pragma unroll
    for (int i = 0; i < 16; ++i) qv[i] = __bfloat162float(q[bh * tq * D + 16 * sub + i]);
    cp_async_wait<0>();
    __syncthreads();                  // barriers initialised; scales in place
    mbar_wait(smem_u32(&bars[0]));

    for (int r = 0; r < tq; ++r) {
        if (r > 0) {
            __syncthreads();          // the last row is done with p_s and part
#pragma unroll
            for (int i = 0; i < 16; ++i)
                qv[i] = __bfloat162float(q[(bh * tq + r) * D + 16 * sub + i]);
        }

        // scores, four lanes a key
        float mx = -INFINITY;
        for (int t0 = 0; t0 < valid_len; t0 += KEYS) {
            const int t = t0 + key;
            float s = 0.0f;
            if (t < valid_len) {
                const uint4 kv = *reinterpret_cast<const uint4*>(k_s + t * D + 16 * sub);
                const uint32_t words[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    float f[4];
                    bytes_to_float(words[w], f);
#pragma unroll
                    for (int j = 0; j < 4; ++j) s = fmaf(qv[4 * w + j], f[j], s);
                }
            }
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (t < valid_len) {
                s *= scale_at(ks_s, ks_pad, t) * SCALE_LOG2;
                if (sub == 0) p_s[t] = s;
                mx = fmaxf(mx, s);
            }
        }
        mx = warp_max(mx);
        if (lane == 0) red[0][warp] = mx;
        __syncthreads();
        mx = red[0][0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[0][w]);

        float sum = 0.0f;
        for (int t = tid; t < valid_len; t += THREADS) {
            const float p = exp2f(p_s[t] - mx);
            p_s[t] = p;
            sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) red[1][warp] = sum;
        __syncthreads();
        sum = red[1][0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += red[1][w];
        const float inv = 1.0f / sum;
        if (r == 0) mbar_wait(smem_u32(&bars[1]));

        // P·V, four lanes a key: weights × vs rounded to bf16 first
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
        for (int t = key; t < valid_len; t += KEYS) {
            const float w = __bfloat162float(
                __float2bfloat16(p_s[t] * inv * scale_at(vs_s, vs_pad, t)));
            const uint4 vv = *reinterpret_cast<const uint4*>(v_s + t * D + 16 * sub);
            const uint32_t words[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                float f[4];
                bytes_to_float(words[x], f);
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[4 * x + j] = fmaf(w, f[j], acc[4 * x + j]);
            }
        }
        // the warp's 8 keys (lanes sub, sub + 4, ...), then the 4 warps
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 4);
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
        }
        if (lane < KEY_LANES) {
#pragma unroll
            for (int i = 0; i < 16; ++i) part[warp][16 * sub + i] = acc[i];
        }
        __syncthreads();
        if (tid < D) {
            float s = part[0][tid];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) s += part[w][tid];
            o[(bh * tq + r) * D + tid] = __float2bfloat16(s);
        }
    }
}

size_t smem_bytes(int t_len) {
    return (size_t)2 * t_len * D + 2 * (size_t)scale_bytes(t_len) +
           (size_t)t_len * sizeof(float);
}

}  // namespace

// q, o: (bh, tq, 64) bf16; kq, vq: (bh, t_len, 64) int8, 16-byte
// aligned; ks, vs: (bh, t_len) bf16; bh = batch·n_head. All contiguous;
// 1 ≤ t_len ≤ 1536 (ops/attention.py:SELF_MAX_KEYS). valid_len: one
// int32 in device memory, read by the kernel (clamped to [1, t_len]).
// Returns cudaGetLastError() after the launch.
extern "C" int tww_self_attention_int8(const void* q, const void* kq, const void* ks,
                                       const void* vq, const void* vs, void* o, int bh,
                                       int tq, int t_len, const void* valid_len,
                                       void* stream) {
    const size_t smem = smem_bytes(t_len);
    if (smem > MAX_SMEM - 2 * 1024) return (int)cudaErrorInvalidValue;
    // ~1.1 KB of static shared memory beside the dynamic; the limit is
    // raised once to each larger size, so a launch being captured into a
    // CUDA graph after an eager one makes no attribute call
    static size_t raised = 46 * 1024;
    if (smem > raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            self_attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        raised = smem;
    }
    self_attention_int8_kernel<<<bh, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const __nv_bfloat16*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const __nv_bfloat16*>(vs), static_cast<__nv_bfloat16*>(o), tq, t_len,
        static_cast<const int*>(valid_len));
    return (int)cudaGetLastError();
}

extern "C" const char* tww_self_attention_int8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
