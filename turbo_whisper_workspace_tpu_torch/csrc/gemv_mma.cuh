// The split-K GEMV skeleton shared by int8_matmul.cu (its decode regime,
// M ≤ 8), s8_matmul.cu and s8g4_matmul.cu (M ≤ 16): a (K, N) row-major
// int8 weight (or (K/2, N) packed int4) streamed once at a few rows of x,
// HBM-bound.
//
// Layout. A block of GEMV_WARPS warps owns GEMV_COLS = 128 columns; lane
// (g, t) = (lane / 4, lane % 4) owns the 16 columns 16g .. 16g + 15 and,
// in every K step of its warp, R consecutive rows picked by t, each read
// by one 16-byte load (a warp's load covers four 128-byte runs). The
// products run on mma.sync with the weight as A (its columns are A's
// rows) and x as B (x's rows are B's columns, masked to 8 a tile):
// lane (g, t)'s A fragment of product j holds columns 16g + 2j and
// 16g + 2j + 1 (A rows g and g + 8) at its own rows, so no byte leaves
// the lane that loaded it; the K order inside a step is a fixed
// permutation that x's fragment follows. Its accumulator c[e] of
// product j is x row 8·nt + 2t + (e & 1), column 16g + 2j + (e >> 1).
//
// Filling the card: the warps of a block take the K steps of its slice
// in turn (warp w takes steps w, w + GEMV_WARPS, ...), and the plan
// (gemv_split, mirrored by ops/quant.py:int8_plan and
// scripts/profile_llm_ops.py:s8_plan) splits K over a thread-block
// cluster of up to 8 blocks when the column tiles alone give fewer than
// GEMV_BLOCKS blocks. The partial sums meet in a fixed order, so results
// are the same from run to run: the warps' in shared memory in warp
// order, then the ranks' through distributed shared memory in rank
// order (gemv_fold). No atomics. s8g4_matmul.cu splits K by group pairs
// instead and folds its f32 group terms in group order (its own fold).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_blocks.cuh"

namespace cg = cooperative_groups;

constexpr int GEMV_WARPS = 8;               // warps of a block, one column tile
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int GEMV_COLS = 128;              // a block's columns: 8 lane groups × 16
constexpr int GEMV_MAX_SPLIT = 8;           // the portable cluster size
constexpr int GEMV_BLOCKS = 264;            // blocks a split aims for: two an SM on 132

// The K split (cluster size) of `steps` K steps over n columns: doubled
// while the blocks stay within GEMV_BLOCKS and every warp keeps a step.
inline int gemv_split(int steps, int n) {
    const int tiles = (n + GEMV_COLS - 1) / GEMV_COLS;
    int split = 1;
    while (split < GEMV_MAX_SPLIT && 2 * tiles * split <= GEMV_BLOCKS &&
           2 * split * GEMV_WARPS <= steps)
        split *= 2;
    return split;
}

// 16 bytes of the weight, not kept in L1 (each byte is read once)
__device__ __forceinline__ uint4 gemv_load16(const int8_t* p) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

// row `row` of the weight at columns col .. col + 15 (zeros past k rows
// or n columns): one 16-byte load where the rows are 16-byte aligned
// (WIDE), else four 4-byte loads (n a multiple of 4)
template <bool WIDE>
__device__ __forceinline__ uint4 gemv_row16(const int8_t* w, int row, int col, int k, int n) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= k) return v;
    const int8_t* p = w + (size_t)row * n + col;
    if (WIDE) {
        if (col < n) v = gemv_load16(p);
    } else {
        if (col < n) v.x = __ldg(reinterpret_cast<const unsigned*>(p));
        if (col + 4 < n) v.y = __ldg(reinterpret_cast<const unsigned*>(p + 4));
        if (col + 8 < n) v.z = __ldg(reinterpret_cast<const unsigned*>(p + 8));
        if (col + 12 < n) v.w = __ldg(reinterpret_cast<const unsigned*>(p + 12));
    }
    return v;
}

__device__ __forceinline__ unsigned gemv_word(const uint4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The A fragments of the 8 int8 products of one K step of 32 rows:
// lane (g, t)'s rows r0 + 8t + i (wv[i], i < 8) of its 16 columns, each
// 4 × 4 byte block transposed (int8_blocks.cuh). Product j = 2q + h takes
// columns 4q + 2h (A row g) and 4q + 2h + 1 (A row g + 8); its depth
// 4t .. 4t + 3 stands for rows i = 0..3 and 16 + 4t .. for rows 4..7, so
// x's B fragment is the 8 bytes of one x row at the lane's 8 rows.
__device__ __forceinline__ void gemv_fragments(const uint4 (&wv)[8], unsigned (&a)[8][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {                // columns 4q .. 4q + 3
        unsigned lo[4], hi[4], tl[4], th[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            lo[i] = gemv_word(wv[i], q);
            hi[i] = gemv_word(wv[4 + i], q);
        }
        transpose4x4(lo, tl);                    // tl[c]: column 4q + c at rows 0..3
        transpose4x4(hi, th);                    // th[c]: at rows 4..7
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            a[2 * q + h][0] = tl[2 * h];
            a[2 * q + h][1] = tl[2 * h + 1];
            a[2 * q + h][2] = th[2 * h];
            a[2 * q + h][3] = th[2 * h + 1];
        }
    }
}

// This block's column tile and its K steps [begin, end), from the
// cluster's rank: rank r of `split` takes steps [r·steps/split,
// (r+1)·steps/split)
struct GemvSlice {
    int n0, begin, end;
};

__device__ __forceinline__ GemvSlice gemv_slice(int steps) {
    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    return {(int)(blockIdx.x / split) * GEMV_COLS, rank * steps / split,
            (rank + 1) * steps / split};
}

// The fold: every warp's fragments (acc[nt][j][e], T = float or int)
// into red[warp][row][col] (rows < m of 8·NT), summed in warp order,
// then over the cluster's ranks in rank order, each rank finishing its
// share of the tile's (row, column) pairs; store(row, column, sum) is
// called once per output of the tile inside m × n. `red` holds
// GEMV_WARPS × 8·NT × GEMV_COLS values.
template <int NT, typename T, typename Store>
__device__ __forceinline__ void gemv_fold(const T (&acc)[NT][8][4], T* red, int m, int n0,
                                          int n, Store store) {
    constexpr int ROWS = 8 * NT;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    T* mine = red + warp * ROWS * GEMV_COLS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = 8 * nt + 2 * t + (e & 1);
                if (row < m) mine[row * GEMV_COLS + 16 * g + 2 * j + (e >> 1)] = acc[nt][j][e];
            }
    __syncthreads();
    const int rows = m < ROWS ? m : ROWS;
    for (int i = threadIdx.x; i < rows * GEMV_COLS; i += GEMV_THREADS) {
        T sum = red[i];
#pragma unroll
        for (int w = 1; w < GEMV_WARPS; ++w) sum += red[w * ROWS * GEMV_COLS + i];
        red[i] = sum;
    }
    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    cluster.sync();                          // every rank's block sum is in place
    const int total = rows * GEMV_COLS;
    const int lo = rank * total / split;
    const int hi = (rank + 1) * total / split;
    for (int i = lo + threadIdx.x; i < hi; i += GEMV_THREADS) {
        const int col = n0 + i % GEMV_COLS;
        if (col >= n) continue;
        T sum = *cluster.map_shared_rank(red + i, 0);
        for (int q = 1; q < split; ++q) sum += *cluster.map_shared_rank(red + i, q);
        store(i / GEMV_COLS, col, sum);
    }
    cluster.sync();      // no block leaves while another still reads its shared memory
}

// Launches `kernel` on tiles × split blocks of GEMV_THREADS in clusters
// of `split` along x with `smem` bytes of dynamic shared memory (the
// kernel's limit raised first where it exceeds 48 KB). Returns the
// launch's error.
template <typename... Params, typename... Args>
cudaError_t gemv_launch(void (*kernel)(Params...), int n, int split, int smem,
                        cudaStream_t stream, Args... args) {
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((n + GEMV_COLS - 1) / GEMV_COLS) * split);
    cfg.blockDim = dim3(GEMV_THREADS);
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
