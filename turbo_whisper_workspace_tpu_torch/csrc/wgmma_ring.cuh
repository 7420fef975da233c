// Helpers shared by the weight-only matmuls that run wgmma on tiles their
// producer warpgroups dequantize (int4_matmul.cu, int8_matmul.cu): the
// tile geometry, cp.async, mbarriers, the wgmma descriptor and product,
// the plan's K split, the consumer warpgroups' loop and the epilogue that
// folds the f32 tile over a thread-block cluster.
//
// A block computes a BM × BN output tile: two consumer warpgroups of 128
// rows (MT m64 accumulators each, all BN columns) and the kernel's
// producer warpgroups, over a ring of STAGES stages in dynamic shared
// memory. A stage starts with A (BM x rows of 64 bf16, 128 bytes, in the
// 128-byte swizzle) and B (64 × BN bf16, written MN-major as two
// 64-column panels in the 128-byte swizzle); the kernel keeps its own
// bytes after them.
// The consumers wait on the stage's "full" mbarrier, issue 2 × 4 wgmma
// m64n128k16 (A K-major, B MN-major through the transpose bit), keep one
// chunk's products in flight and release the stage before on its "empty"
// mbarrier. Stores by ordinary threads reach wgmma (the async proxy) only
// after fence.proxy.async.shared::cta, which a producer issues before it
// arrives on "full".
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

constexpr int MT = 2;                    // m64 tiles per consumer warpgroup
constexpr int BM = 2 * 64 * MT;          // output rows per block (2 consumer warpgroups)
constexpr int BN = 128;                  // output columns per block
constexpr int CONSUMERS = 256;           // a consumer holds 64·MT accumulators
constexpr int A_BYTES = BM * 128;        // BM rows × 64 bf16
constexpr int B_BYTES = 64 * BN * 2;     // 64 rows × BN bf16
constexpr int PART_LD = BN + 8;          // f32 partial tile row, padded
constexpr int SMS = 132;
constexpr int MAX_SPLIT = 4;
constexpr int MAX_BLOCK_SMEM = 232448;   // shared memory one block may use

// The K split (cluster size) of an m × n product of `chunks` chunks: 1
// when the tiles alone fill the card; else doubled (to at most
// MAX_SPLIT, and at most half the chunks) until tiles × split ≥ SMS.
// Mirrored by ops/quant.py:int4_plan and int8_plan.
inline int ring_split(int m, int n, int chunks) {
    const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
    int split = 1;
    while (tiles * split < SMS && split < MAX_SPLIT && 2 * split <= chunks) split *= 2;
    return split;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// every stage's "full" barrier counts the producers, "empty" the consumers
template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* full_bar, uint64_t* empty_bar,
                                          int producers) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_addr(&full_bar[s]), producers);
            mbar_init(smem_addr(&empty_bar[s]), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 in bits
// 62-63. Tiles are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
           (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define TWW_ACC16(d, o)                                                                    \
    "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),        \
        "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),    \
        "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), \
        "+f"(d[o + 15])

// d (64x128 f32) += A (64x16 bf16, K-major in shared memory) ·
// B (16x128 bf16, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : TWW_ACC16(d, 0), TWW_ACC16(d, 16), TWW_ACC16(d, 32), TWW_ACC16(d, 48)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The consumer warpgroups (threads 0..CONSUMERS-1): n_local chunks of
// the ring at `base`, each STAGE_BYTES apart; then, once both
// warpgroups' products are done, the f32 tile (BM, PART_LD) written to
// `part`, over the ring.
template <int STAGES, int STAGE_BYTES>
__device__ __forceinline__ void ring_consume(uint32_t base, uint64_t* full_bar,
                                             uint64_t* empty_bar, int n_local, float* part) {
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    float acc[MT][64];
#pragma unroll
    for (int h = 0; h < MT; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
    for (int j = 0; j < n_local; ++j) {
        const int s = j % STAGES;
        mbar_wait(smem_addr(&full_bar[s]), (j / STAGES) & 1);
        const uint32_t a_s = base + s * STAGE_BYTES + wg * MT * (64 * 128);
        const uint32_t b_s = base + s * STAGE_BYTES + A_BYTES;
#pragma unroll
        for (int h = 0; h < MT; ++h) fence_regs(acc[h]);
        wgmma_fence();
        // k16 steps: 32 bytes apart in A's swizzled rows; 16 B rows (2048
        // bytes) apart in B, whose two 64-column panels lie 8192 bytes apart
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h = 0; h < MT; ++h)
                wgmma_n128(acc[h], smem_desc(a_s + h * (64 * 128) + 32 * kk, 16, 1024),
                           smem_desc(b_s + 2048 * kk, 64 * 128, 1024));
        wgmma_commit();
        wgmma_wait<1>();                         // chunk j − 1's products are done
#pragma unroll
        for (int h = 0; h < MT; ++h) fence_regs(acc[h]);
        if (j > 0) mbar_arrive(smem_addr(&empty_bar[(j - 1) % STAGES]));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < MT; ++h) fence_regs(acc[h]);
    // both warpgroups' products are done: the ring is no longer read,
    // and the f32 tile goes over it
    asm volatile("bar.sync 2, %0;\n" :: "n"(CONSUMERS) : "memory");
    const int lane = tid % 32;
    const int row0 = wg * MT * 64 + 16 * ((tid % 128) / 32) + lane / 4;
#pragma unroll
    for (int h = 0; h < MT; ++h)
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                *reinterpret_cast<float2*>(part + (row0 + 64 * h + 8 * e) * PART_LD + 8 * c +
                                           2 * (lane % 4)) =
                    make_float2(acc[h][4 * c + 2 * e], acc[h][4 * c + 2 * e + 1]);
}

// The epilogue, all threads: the f32 tile reduced over the cluster, each
// rank summing its share of the tile's rows over the ranks in rank order
// through distributed shared memory, rounded once to bf16 and written by
// 8-byte stores; ragged M and N masked (n a multiple of 4).
__device__ __forceinline__ void ring_fold_store(const float* part, __nv_bfloat16* out, int m0,
                                                int n0, int m, int n) {
    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    cluster.sync();
    const int rows = BM / split;
    for (int i = threadIdx.x; i < rows * (BN / 4); i += blockDim.x) {
        const int r = rank * rows + i / (BN / 4);
        const int c = 4 * (i % (BN / 4));
        if (m0 + r >= m || n0 + c >= n) continue;
        float4 v[MAX_SPLIT];
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q)      // the remote reads in parallel
            v[q] = q < split ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(
                                   const_cast<float*>(part) + r * PART_LD + c, q))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 sum = v[0];
#pragma unroll
        for (int q = 1; q < MAX_SPLIT; ++q) {
            sum.x += v[q].x;
            sum.y += v[q].y;
            sum.z += v[q].z;
            sum.w += v[q].w;
        }
        *reinterpret_cast<uint2*>(out + (size_t)(m0 + r) * n + n0 + c) =
            make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    }
    cluster.sync();      // no block leaves while another still reads its shared memory
}

// Launches `kernel` on grid (row tiles × split, column tiles) of blocks of
// `threads` in clusters of `split` along x with `smem` bytes of dynamic
// shared memory; the kernel's limit is raised on its first launch
// (`raised`, one flag per kernel). Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t ring_launch(void (*kernel)(Params...), bool& raised, int threads, int smem, int m,
                        int n, int split, cudaStream_t stream, Args... args) {
    if (!raised) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        raised = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((m + BM - 1) / BM) * split, (n + BN - 1) / BN);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}
