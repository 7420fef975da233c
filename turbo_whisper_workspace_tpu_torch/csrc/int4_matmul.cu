// Grouped int4 weight-only matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/quant.py:
// int4_matmul (body _q4_matmul_kernel with _dequant4_halves, pallas_call
// at :177). The weight is packed (K/2, N) int8: the low nibble of byte
// (r, n) is W row r, the high nibble W row r + K/2, both sign-extended;
// scale (n_groups, N) f32 holds one scale per (group of G = K/n_groups
// rows, column). Each weight is nibble × scale in f32, rounded once to
// bf16; out = x_lo @ lo + x_hi @ hi over bf16(x) with f32 sums, rounded
// to bf16.
//
// What bounds it on the H100: on the LLM's path it is every body
// projection of the prefill, M = P prompt rows, (K, N) in {(4096, 4096),
// (4096, 1024), (4096, 14336), (14336, 4096)}. At M = 512, (4096, 14336)
// it does 60.1 GFLOP on 29 MB of packed weights, about 2000 operations
// per byte: bound by the bf16 tensor cores (0.061 ms), not HBM. So the
// products must run on wgmma, the only path to that rate, and the
// dequantization must run beside them, not before them.
//
// Design: one block per 256 × 128 output tile: two consumer warpgroups
// (128 rows each, two m64 accumulators) and one producer warpgroup, over
// a 4-stage ring in shared memory. A stage holds one chunk of 32 packed
// rows [r0, r0+32):
//   A: 256 x rows of 64 bf16 (128 bytes) in the 128-byte swizzle, x
// columns [r0, r0+32) beside [K/2+r0, K/2+r0+32), so the chunk is one
// product of depth 64 against B = [lo rows; hi rows];
//   W: the 32 × 128 packed bytes;
//   B: 64 × 128 bf16, written MN-major (columns contiguous) as two
// 64-column panels in the 128-byte swizzle.
// The producer issues 16-byte cp.async copies of A and W a chunk ahead
// (4-byte copies where N % 16 or w's alignment forbid; rows past M
// zero-filled) and may run two chunks ahead of the consumers; it
// dequantizes chunk j's W into B: a byte permute puts
// each nibble (offset by 8) under the exponent of 2^23 and one
// subtraction makes it an exact float, which is multiplied by its f32
// scale and rounded once to bf16, as the TPU kernel does. Stores by
// ordinary threads become visible to wgmma (the async proxy) through
// fence.proxy.async.shared::cta before the producer arrives on the
// stage's "full" mbarrier. Scales are read from global memory a chunk
// ahead into registers where G % 4 == 0 (a thread's four rows share a
// group), row by row otherwise. The consumers wait on "full", issue
// 2 × 4 wgmma m64n128k16 per chunk (A K-major, B MN-major through the
// transpose bit), keep one chunk's products in flight and release the
// stage before on its "empty" mbarrier, so the dequantization of chunk
// j runs under the products of chunk j − 1. The producer's work a chunk
// is fixed by the tile's columns and the products' by its rows: 256 rows
// a tile (not 128) halve the dequantization per product, which bounded
// the 128-row design.
//   Filling the card: the plan (make_plan, mirrored by
// ops/quant.py:int4_plan) splits K over a thread-block cluster of 2 or
// 4 blocks when the tiles alone number fewer than 132; each rank leaves
// its f32 partial tile in shared memory and, after a cluster barrier,
// sums its share of the tile's rows over the ranks in rank order through
// distributed shared memory. Every tile ends that way (a cluster of one
// without a split), so the output is written by coalesced 8-byte stores;
// ragged M and N are masked there.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int MT = 2;                    // m64 tiles per consumer warpgroup
constexpr int BM = 2 * 64 * MT;          // output rows per block (2 consumer warpgroups)
constexpr int BN = 128;                  // output columns per block
constexpr int BKP = 32;                  // packed rows per chunk: a product of depth 64
constexpr int STAGES = 4;
// chunks whose copies are in flight ahead of the one being dequantized;
// the producer may run STAGES − AHEAD − 1 chunks ahead of the consumers
constexpr int AHEAD = 1;
constexpr int CONSUMERS = 256;
constexpr int PRODUCERS = 128;           // registers: a consumer holds 64·MT accumulators
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int RPT = BKP * 16 / PRODUCERS;   // packed rows a producer thread dequantizes
constexpr int A_BYTES = BM * 128;
constexpr int B_BYTES = 64 * BN * 2;     // 64 rows × BN bf16
constexpr int W_BYTES = BKP * BN;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES + W_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + 1024-byte alignment
constexpr int PART_LD = BN + 8;          // f32 partial tile row, padded
constexpr int SMS = 132;
constexpr int MAX_SPLIT = 4;

static_assert(STAGES - AHEAD - 1 >= 1, "the producer runs a chunk ahead of the consumers");
static_assert(BM * PART_LD * 4 <= STAGES * STAGE_BYTES, "the partial tile reuses the ring");
static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles are 1024-byte aligned");
static_assert(SMEM_BYTES + 1024 <= 232448, "the ring fits one block's shared memory");

// mirrored by ops/quant.py:int4_plan: the K split (cluster size)
int make_plan(int m, int k, int n) {
    const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
    const int chunks = (k / 2 + BKP - 1) / BKP;
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

// byte j of u (a nibble offset by 8, so 0..15) under the exponent of
// 2^23, minus 2^23 + 8: the sign-extended nibble as an exact float
__device__ __forceinline__ float nibble(uint32_t u, int j) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388616.0f;
}

// 8 packed bytes (8 columns) → their low-nibble weights (lo) and
// high-nibble weights (hi), bf16(nibble × scale) with the product in f32;
// s = lo scales (2 float4), then hi scales (2 float4)
__device__ __forceinline__ void dequant8(uint2 wv, const float4 (&s)[4], uint4& lo, uint4& hi) {
    const float sl[8] = {s[0].x, s[0].y, s[0].z, s[0].w, s[1].x, s[1].y, s[1].z, s[1].w};
    const float sh[8] = {s[2].x, s[2].y, s[2].z, s[2].w, s[3].x, s[3].y, s[3].z, s[3].w};
    const uint32_t words[2] = {wv.x, wv.y};
    float fl[8], fh[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t l4 = (words[h] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t h4 = ((words[h] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            fl[4 * h + j] = nibble(l4, j) * sl[4 * h + j];
            fh[4 * h + j] = nibble(h4, j) * sh[4 * h + j];
        }
    }
    lo = make_uint4(pack_bf16(fl[0], fl[1]), pack_bf16(fl[2], fl[3]), pack_bf16(fl[4], fl[5]),
                    pack_bf16(fl[6], fl[7]));
    hi = make_uint4(pack_bf16(fh[0], fh[1]), pack_bf16(fh[2], fh[3]), pack_bf16(fh[4], fh[5]),
                    pack_bf16(fh[6], fh[7]));
}

__global__ void __launch_bounds__(THREADS, 1)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                   int m, int k, int n, int group, int wide) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full_bar[STAGES];
    __shared__ __align__(8) uint64_t empty_bar[STAGES];
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    // the f32 tile (BM, PART_LD), written over the ring once it is done
    float* part = reinterpret_cast<float*>(smem_raw + (base - raw));

    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int m0 = (blockIdx.x / split) * BM;
    const int n0 = blockIdx.y * BN;
    const int half = k / 2;
    const int half_groups = half / group;
    const int chunks = (half + BKP - 1) / BKP;
    const int c_begin = rank * chunks / split;
    const int n_local = (rank + 1) * chunks / split - c_begin;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init((uint32_t)__cvta_generic_to_shared(&full_bar[s]), PRODUCERS);
            mbar_init((uint32_t)__cvta_generic_to_shared(&empty_bar[s]), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ---- producer threads: copies, then dequantization ----
        const int pt = tid - CONSUMERS;
        const int c8 = pt % 16;              // columns n0 + 8·c8 .. + 7
        const int rg = pt / 16;              // packed rows RPT·rg .. of a chunk
        const int col = n0 + 8 * c8;
        const bool fast = group % RPT == 0;  // a thread's rows share a group
        // this thread's copies, the same in every chunk but for r0: x
        // columns chunk xc of rows pt / 8 + (PRODUCERS / 8)·u, W bytes
        // 16·wq (or 4·wq) of rows pt / 8 + ...
        constexpr int XN = BM * 8 / PRODUCERS;
        constexpr int XROWS = PRODUCERS / 8;     // rows between a thread's copies
        const int xc = pt % 8;
        const int x_row = pt / 8;
        const __nv_bfloat16* x_src =
            x + (size_t)(m0 + x_row) * k + (xc < 4 ? 0 : half) + 8 * (xc % 4);
        // the swizzled chunk: x_row % 8 is the same for every copy (XROWS % 8 == 0)
        const uint32_t x_dst = x_row * 128 + ((xc ^ (x_row % 8)) << 4);
        static_assert(XROWS % 8 == 0, "a thread's rows share their swizzle");

        auto issue = [&](int j) {
            if (j < n_local) {
                const int s = j % STAGES;
                if (j >= STAGES)
                    mbar_wait((uint32_t)__cvta_generic_to_shared(&empty_bar[s]),
                              ((j / STAGES) - 1) & 1);
                const uint32_t a_s = base + s * STAGE_BYTES;
                const uint32_t w_s = a_s + A_BYTES + B_BYTES;
                const int r0 = (c_begin + j) * BKP;
                const bool k_ok = r0 + 8 * (xc % 4) < half;
#pragma unroll
                for (int u = 0; u < XN; ++u) {
                    const bool ok = k_ok && m0 + x_row + XROWS * u < m;
                    cp_async16(a_s + x_dst + XROWS * 128 * u,
                               ok ? x_src + (size_t)XROWS * u * k + r0 : x, ok ? 16u : 0u);
                }
                if (wide) {
#pragma unroll
                    for (int u = 0; u < BKP * (BN / 16) / PRODUCERS; ++u) {
                        const int rr = pt / 8 + (PRODUCERS / 8) * u;
                        const int q = pt % 8;
                        if (r0 + rr < half && n0 + 16 * q < n)
                            cp_async16(w_s + rr * BN + 16 * q,
                                       w + (size_t)(r0 + rr) * n + n0 + 16 * q, 16u);
                    }
                } else {
                    for (int i = pt; i < BKP * (BN / 4); i += PRODUCERS) {
                        const int rr = i / (BN / 4);
                        const int q = i % (BN / 4);
                        if (r0 + rr < half && n0 + 4 * q < n)
                            cp_async4(w_s + rr * BN + 4 * q, w + (size_t)(r0 + rr) * n + n0 + 4 * q);
                    }
                }
            }
            cp_async_commit();
        };

        // the lo and hi scales of this thread's 8 columns in group g
        auto load_scales = [&](int g, float4 (&s)[4]) {
            const float* lo = scale + (size_t)g * n + col;
            const float* hi = scale + (size_t)(g + half_groups) * n + col;
            const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            s[0] = col < n ? __ldg(reinterpret_cast<const float4*>(lo)) : zero;
            s[1] = col + 4 < n ? __ldg(reinterpret_cast<const float4*>(lo + 4)) : zero;
            s[2] = col < n ? __ldg(reinterpret_cast<const float4*>(hi)) : zero;
            s[3] = col + 4 < n ? __ldg(reinterpret_cast<const float4*>(hi + 4)) : zero;
        };

        for (int j = 0; j < AHEAD; ++j) issue(j);
        float4 next[4];
        {
            const int row = c_begin * BKP + RPT * rg;
            if (fast && row < half) load_scales(row / group, next);
        }
        for (int j = 0; j < n_local; ++j) {
            issue(j + AHEAD);
            float4 cur[4] = {next[0], next[1], next[2], next[3]};
            const int r0 = (c_begin + j) * BKP;
            if (fast && j + 1 < n_local && r0 + BKP + RPT * rg < half)
                load_scales((r0 + BKP + RPT * rg) / group, next);   // a chunk ahead
            cp_async_wait<AHEAD>();                  // chunk j's copies (this thread's)
            asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");   // everyone's
            const int s = j % STAGES;
            const uint32_t a_s = base + s * STAGE_BYTES;
            const uint32_t b_s = a_s + A_BYTES;
            const uint8_t* w_s = smem_raw + (a_s + A_BYTES + B_BYTES - raw);
            // B rows rr (lo) and 32 + rr (hi), column chunk c8 % 8 of panel c8 / 8
            uint8_t* panel = smem_raw + (b_s - raw) + (c8 / 8) * (64 * 128);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int rr = RPT * rg + i;
                uint4 lo = make_uint4(0u, 0u, 0u, 0u);
                uint4 hi = lo;
                if (r0 + rr < half) {
                    if (!fast) load_scales((r0 + rr) / group, cur);
                    dequant8(*reinterpret_cast<const uint2*>(w_s + rr * BN + 8 * c8), cur, lo, hi);
                }
                const int sw = ((c8 % 8) ^ (rr % 8)) << 4;
                *reinterpret_cast<uint4*>(panel + rr * 128 + sw) = lo;
                *reinterpret_cast<uint4*>(panel + (32 + rr) * 128 + sw) = hi;
            }
            // the copies and the stores, visible to wgmma (the async proxy)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive((uint32_t)__cvta_generic_to_shared(&full_bar[s]));
        }
        cp_async_wait<0>();
    } else {
        // ---- consumer warpgroups: 64·MT rows each, all BN columns ----
        const int wg = tid / 128;
        float acc[MT][64];
#pragma unroll
        for (int h = 0; h < MT; ++h)
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
        for (int j = 0; j < n_local; ++j) {
            const int s = j % STAGES;
            mbar_wait((uint32_t)__cvta_generic_to_shared(&full_bar[s]), (j / STAGES) & 1);
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
            if (j > 0)
                mbar_arrive((uint32_t)__cvta_generic_to_shared(&empty_bar[(j - 1) % STAGES]));
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

    // ---- epilogue: the f32 tile reduced over the cluster ----
    cluster.sync();
    const int rows = BM / split;
    for (int i = tid; i < rows * (BN / 4); i += THREADS) {
        const int r = rank * rows + i / (BN / 4);
        const int c = 4 * (i % (BN / 4));
        if (m0 + r >= m || n0 + c >= n) continue;
        float4 v[MAX_SPLIT];
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q)      // the remote reads in parallel
            v[q] = q < split ? *reinterpret_cast<const float4*>(
                                   cluster.map_shared_rank(part + r * PART_LD + c, q))
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

}  // namespace

// x (m, k) bf16 16-byte aligned, w (k/2, n) packed int8, scale (n_groups,
// n) f32 16-byte aligned, out (m, n) bf16; all dense, k a multiple of 16,
// n of 4, n_groups even and dividing k. Returns cudaGetLastError() after
// the launch (or the launch's own error).
extern "C" int tww_int4_matmul(const void* x, const void* w, const void* scale, void* out,
                               int m, int k, int n, int n_groups, void* stream) {
    static bool raised = false;      // the shared-memory attribute, once
    if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            int4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const int split = make_plan(m, k, n);
    const int wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((m + BM - 1) / BM) * split, (n + BN - 1) / BN);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, int4_matmul_kernel, static_cast<const __nv_bfloat16*>(x),
        static_cast<const int8_t*>(w), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), m, k, n, k / n_groups, wide);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* tww_int4_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
