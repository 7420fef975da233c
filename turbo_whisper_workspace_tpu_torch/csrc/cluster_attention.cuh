// Helpers shared by the attention kernels that run one thread-block
// cluster per (batch, head) (cross_attention_int8.cu,
// cross_attention_s8.cu, self_attention_int8_lanes.cu): the
// cross-attention plan, 16-byte cp.async, warp reductions, int8 bytes as
// exact floats, and the cluster launch. self_attention_int8.cu (one
// block per (batch, head)) takes the cp.async, reductions and bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

constexpr int MAX_RANKS = 8;               // the portable cluster size

// The cross-attention kernels' plan: one cluster of C ≤ 8 blocks per
// (b, h), rank r holding keys [r·S, (r+1)·S), S a multiple of 16 with
// C·S ≥ Tpad and no rank wholly past Tpad; query rows in even chunks of
// at most 8. Mirrored by ops/attention.py:cross_int8_plan.
constexpr int CROSS_KEYS_PER_RANK = 128;   // the slice aimed at before rounding
constexpr int CROSS_MAX_SLICE = 1024;      // keys a block holds (Tpad ≤ 8192)
constexpr int CROSS_MAX_ROWS = 8;          // query rows a chunk

struct CrossPlan {
    int ranks, slice, rows;
};

inline CrossPlan cross_plan(int tq, int tpad) {
    int ranks = (tpad + CROSS_KEYS_PER_RANK - 1) / CROSS_KEYS_PER_RANK;
    ranks = ranks < 1 ? 1 : (ranks > MAX_RANKS ? MAX_RANKS : ranks);
    const int slice = ((tpad + ranks - 1) / ranks + 15) / 16 * 16;
    ranks = (tpad + slice - 1) / slice;
    const int chunks = (tq + CROSS_MAX_ROWS - 1) / CROSS_MAX_ROWS;
    return {ranks, slice, (tq + chunks - 1) / chunks};
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the four signed bytes of w as exact floats: each byte, offset by 128,
// is placed under the exponent of 2^23 and the offset subtracted (the
// int→float converter runs at a quarter of the FMA rate)
__device__ __forceinline__ void bytes_to_float(uint32_t w, float (&f)[4]) {
    constexpr float MAGIC = 8388608.0f + 128.0f;   // 2^23 + the byte's offset
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - MAGIC;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// `blocks` blocks of `threads` in clusters of `ranks` along x, with `smem`
// bytes of dynamic shared memory beside the kernel's `static_smem`
// (above the 48 KB default only after raising the kernel's limit)
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads, int ranks,
                            size_t smem, size_t static_smem, cudaStream_t stream,
                            Args... args) {
    if (smem + static_smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}
