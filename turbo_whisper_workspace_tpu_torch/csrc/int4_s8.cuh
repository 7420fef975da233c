// The W4A8 sweep of int4_matmul_s8.cu (its design is described there),
// shared with int4_moe_s8.cu: the block's staging, its streamed sweep of
// packed rows, the terms rounded as the TPU kernel rounds them, and the
// fold in group order (in shared memory, or across the ranks of a
// thread-block cluster where K is split), and the launch. Each source
// wraps s8_sweep in a __global__ of its own name; the expert product
// reads its row's expert id from device memory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_blocks.cuh"

namespace cg = cooperative_groups;

namespace {


constexpr int WARPS = 8;               // ops/quant.py's S8_WARPS plans for as many
constexpr int THREADS = 32 * WARPS;
constexpr int M_CHUNK = 8;            // rows of M per block
constexpr int COL_LANES = 8;          // lanes of a warp along N
constexpr int ROW_LANES = 4;          // lanes of a warp along the packed rows
constexpr int UNROLL = 2;             // row quads of a lane in one batch of its sweep
constexpr int MAX_CLUSTER = 8;        // ranks of a split of K: the portable cluster size
constexpr int MAX_SMEM = 232448 - 1024;   // 227 KB a block, less the static part

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The columns of a bn-column tile each rank of a split into `splits`
// folds: rank r takes [r·cols, (r+1)·cols), whole groups of 4 (the last
// rank fewer, or none)
__host__ __device__ constexpr int fold_cols(int bn, int splits) {
    return 4 * ((bn / 4 + splits - 1) / splits);
}

// Shared-memory layout of a block with mt rows of M, pb group pairs and
// bn columns, of a split into `splits` ranks: xq bytes [mt][2][pb·G], xs
// [mt][2·pb], ws [2·pb][bn], the dots (then terms) [2·pb][mt][bn], and
// with a split the terms of the columns this rank folds, as every rank
// of the cluster sends them, [n_groups][mt][fold_cols].
struct Layout {
    int xs, ws, terms, fold, bytes;
    __host__ __device__ Layout(int mt, int pb, int group, int bn, int n_groups, int splits) {
        xs = align16(mt * 2 * pb * group);
        ws = align16(xs + mt * 2 * pb * 4);
        terms = ws + 2 * pb * bn * 4;
        fold = terms + 2 * pb * mt * bn * 4;
        bytes = fold + (splits > 1 ? n_groups * mt * fold_cols(bn, splits) * 4 : 0);
    }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// CG words (4 columns each) of one packed row at p, or zeros. Volatile
// with a memory clobber: the compiler may not sink a prefetch below the
// shared-memory reads of the batch computed meanwhile, which it otherwise
// does to save the registers the loads in flight hold. L2::256B: L2
// fetches the neighbouring 128 bytes of the row, which the next column
// tile reads.
template <int CG>
__device__ __forceinline__ void load_words(const int8_t* p, bool ok, unsigned (&out)[CG]) {
    if constexpr (CG == 4)
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
            "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
            "@p ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
            : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3])
            : "l"(p), "r"((int)ok) : "memory");
    else
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\nmov.b32 %0, 0;\n"
            "@p ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];\n}\n"
            : "=r"(out[0]) : "l"(p), "r"((int)ok) : "memory");
}

// The expert product's rows (int4_moe_s8.cu); unused by the dense one.
struct ExpertRows {
    const long long* ids;      // the expert of each output row
    int x_div;                 // output rows a row of xq feeds
    int split_n;               // > 0: columns c >= split_n go to a second (m, split_n) plane
    int n_experts;
};

// out's element of (row, col) of an (m, n) product: row-major, or for an
// expert product with split_n, plane col / split_n of (m, split_n)
template <bool MOE>
__device__ __forceinline__ long long out_index(int row, int col, int m, int n,
                                               const ExpertRows& rows) {
    if constexpr (MOE) {
        if (rows.split_n > 0)
            return ((long long)(col / rows.split_n) * m + row) * rows.split_n +
                   col % rows.split_n;
    }
    return (long long)row * n + col;
}

// The block's sweep, folds and stores. MOE false: the dense product,
// rows m0 = blockIdx.z · M_CHUNK onwards of xq against w. MOE true: one
// output row a block, r = blockIdx.z, whose activations are xq row
// r / rows.x_div and whose weights are expert rows.ids[r] (clamped into
// [0, n_experts): a graph replay never reads past the stack) of the
// stacked w (E, K/2, N) and ws (E, n_groups, N). Where gridDim.y > 1
// (a split of K), the gridDim.y blocks of one (column tile, row chunk)
// are one thread-block cluster along y: rank blockIdx.y takes group
// pairs [blockIdx.y · pb, + pb).
template <int MC, int CG, bool MOE>
__device__ __forceinline__ void s8_sweep(const int8_t* __restrict__ xq,
                                         const float* __restrict__ xs,
                                         const int8_t* __restrict__ w,
                                         const float* __restrict__ ws,
                                         __nv_bfloat16* __restrict__ out, int m, int k, int n,
                                         int n_groups, int pb, const ExpertRows rows) {
    constexpr int BN = COL_LANES * 4 * CG;
    extern __shared__ __align__(16) uint8_t smem[];
    const int splits = gridDim.y;
    // a split: this block has started, which every rank waits for before
    // it writes into another's shared memory
    if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int half = n_groups / 2;
    const int group = k / n_groups;
    const int quads = group / 4;
    const int n0 = blockIdx.x * BN;
    const int pa = blockIdx.y * pb;                   // the block's first pair
    const int np = min(pb, half - pa);                // its pairs
    const int m0 = MOE ? (int)blockIdx.z : (int)blockIdx.z * M_CHUNK;
    const int mt = MOE ? 1 : min(M_CHUNK, m - m0);    // its rows of M
    const int x0 = MOE ? m0 / rows.x_div : m0;        // its first row of xq
    if constexpr (MOE) {
        long long e = rows.ids[m0];
        e = e < 0 ? 0 : (e >= rows.n_experts ? rows.n_experts - 1 : e);
        w += e * (k / 2) * (long long)n;
        ws += e * n_groups * (long long)n;
    }
    const Layout lay(mt, pb, group, BN, n_groups, splits);
    int8_t* xq_s = reinterpret_cast<int8_t*>(smem);
    float* xs_s = reinterpret_cast<float*>(smem + lay.xs);
    float* ws_s = reinterpret_cast<float*>(smem + lay.ws);
    int* dots_s = reinterpret_cast<int*>(smem + lay.terms);
    float* terms_s = reinterpret_cast<float*>(smem + lay.terms);   // the dots, rescaled in place
    const int seg = pb * group;                       // xq bytes of one half of a row

    // stage xq (4-byte words: G is a multiple of 4) and xs, then the
    // block's ws rows (16 bytes a copy), asynchronously: the ws copies
    // land while the sweep runs. Zero the dots meanwhile.
    const int seg_words = np * group / 4;
    for (int i = tid; i < mt * 2 * seg_words; i += THREADS) {
        const int mm = i / (2 * seg_words);
        const int hh = (i / seg_words) % 2;
        const int wi = i % seg_words;
        cp_async<4>(xq_s + mm * 2 * seg + hh * seg + 4 * wi,
                    xq + (long long)(x0 + mm) * k + hh * (k / 2) + pa * group + 4 * wi, true);
    }
    for (int i = tid; i < mt * 2 * np; i += THREADS) {
        const int mm = i / (2 * np);
        const int hh = (i / np) % 2;
        const int lp = i % np;
        cp_async<4>(xs_s + mm * 2 * pb + hh * pb + lp,
                    xs + (long long)(x0 + mm) * n_groups + hh * half + pa + lp, true);
    }
    cp_async_commit();
    for (int i = tid; i < 2 * np * (BN / 4); i += THREADS) {
        const int c = 4 * (i % (BN / 4));
        const int hh = (i / (BN / 4)) / np;
        const int lp = (i / (BN / 4)) % np;
        const bool ok = n0 + c < n;                   // n is a multiple of 4
        cp_async<16>(ws_s + (hh * pb + lp) * BN + c,
                     ws + (long long)(hh * half + pa + lp) * n + (ok ? n0 + c : 0), ok);
    }
    cp_async_commit();
    for (int i = tid; i < 2 * pb * mt * BN; i += THREADS) dots_s[i] = 0;
    // the sweep, streamed: a warp's work is a list of batches (its pair,
    // a row pair of M, UNROLL row quads of each lane; warps that share a
    // pair split its quads), and batch t + 1's loads are issued before
    // batch t is computed
    const int wpp = pb < WARPS ? WARPS / pb : 1;      // warps per pair
    const int sub = warp % wpp;
    const int first = warp / wpp;                     // the warp's first pair
    const int stride = WARPS / wpp;
    const int cl = lane % COL_LANES;
    const int rl = lane / COL_LANES;
    const int col = n0 + cl * 4 * CG;                 // the lane's first column
    const bool col_ok = col < n;                      // n is a multiple of 4·CG
    const int b0 = rl % 2;                            // after the reduce-scatter: column half
    const int b1 = rl / 2;                            //   and nibble plane the lane keeps
    const int q_step = ROW_LANES * wpp;
    const int q_first = rl + ROW_LANES * sub;
    const int nb = ((quads + q_step - 1) / q_step + UNROLL - 1) / UNROLL;   // batches a sweep
    const int sweeps = (mt + MC - 1) / MC;
    const int pairs = first < np ? (np - first + stride - 1) / stride : 0;
    const int total = pairs * sweeps * nb;
    // batch t → pair lp, rows mm0.., quad batch b
    auto where = [&](int t, int& lp, int& mm0, int& b) {
        b = t % nb;
        mm0 = (t / nb) % sweeps * MC;
        lp = first + t / (nb * sweeps) * stride;
    };
    auto load = [&](int t, unsigned (&raw)[UNROLL][4][CG]) {
        int lp, mm0, b;
        where(t, lp, mm0, b);
        const int8_t* wp = w + (long long)(pa + lp) * group * n + col;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int q = q_first + q_step * (b * UNROLL + u);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                load_words<CG>(wp + (long long)(4 * q + i) * n, col_ok && q < quads, raw[u][i]);
        }
    };
    int acc[MC][2][4 * CG];                           // [row][low, high plane][column], ×16
#pragma unroll
    for (int r = 0; r < MC; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 4 * CG; ++c) acc[r][h][c] = 0;
    auto compute = [&](int t, const unsigned (&raw)[UNROLL][4][CG]) {
        int lp, mm0, b;
        where(t, lp, mm0, b);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int q = q_first + q_step * (b * UNROLL + u);
            if (q >= quads) break;
            int xl[MC], xh[MC];
#pragma unroll
            for (int r = 0; r < MC; ++r) {
                const bool ok = mm0 + r < mt;
                const int8_t* xr = xq_s + (mm0 + r) * 2 * seg + lp * group + 4 * q;
                xl[r] = ok ? *reinterpret_cast<const int*>(xr) : 0;
                xh[r] = ok ? *reinterpret_cast<const int*>(xr + seg) : 0;
            }
#pragma unroll
            for (int j = 0; j < CG; ++j) {
                const unsigned rows4[4] = {raw[u][0][j], raw[u][1][j], raw[u][2][j],
                                           raw[u][3][j]};
                unsigned cols4[4];
                transpose4x4(rows4, cols4);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int lo16 = (int)((cols4[c] << 4) & 0xF0F0F0F0u);
                    const int hi16 = (int)(cols4[c] & 0xF0F0F0F0u);
#pragma unroll
                    for (int r = 0; r < MC; ++r) {
                        acc[r][0][4 * j + c] = __dp4a(lo16, xl[r], acc[r][0][4 * j + c]);
                        acc[r][1][4 * j + c] = __dp4a(hi16, xh[r], acc[r][1][4 * j + c]);
                    }
                }
            }
        }
        if (b != nb - 1) return;
        // the sweep's last batch: reduce-scatter over the 4 row lanes (lane
        // bits 4, then 3): the lane keeps plane b1's 2·CG columns of half
        // b0, summed; the warps of the pair meet through shared atomics
#pragma unroll
        for (int r = 0; r < MC; ++r) {
            int plane[4 * CG], red[2 * CG];
#pragma unroll
            for (int c = 0; c < 4 * CG; ++c) {
                const int send = b1 ? acc[r][0][c] : acc[r][1][c];
                const int keep = b1 ? acc[r][1][c] : acc[r][0][c];
                plane[c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
            }
#pragma unroll
            for (int c = 0; c < 2 * CG; ++c) {
                const int send = b0 ? plane[c] : plane[2 * CG + c];
                const int keep = b0 ? plane[2 * CG + c] : plane[c];
                red[c] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
            }
            if (col_ok && mm0 + r < mt) {
                int* d = dots_s + ((lp + b1 * pb) * mt + mm0 + r) * BN + (col - n0) + 2 * CG * b0;
#pragma unroll
                for (int c = 0; c < 2 * CG; ++c) atomicAdd(d + c, red[c]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int c = 0; c < 4 * CG; ++c) acc[r][h][c] = 0;
        }
    };
    unsigned raw_a[UNROLL][4][CG], raw_b[UNROLL][4][CG];
    if (total > 0) load(0, raw_a);                    // in flight while the staging lands
    cp_async_wait<1>();                               // xq and xs
    __syncthreads();
    for (int t = 0; t < total; t += 2) {
        if (t + 1 < total) load(t + 1, raw_b);
        compute(t, raw_a);
        if (t + 1 < total) {
            if (t + 2 < total) load(t + 2, raw_a);
            compute(t + 1, raw_b);
        }
    }
    cp_async_wait<0>();                               // ws
    __syncthreads();

    // terms f32(d) · (xs · ws), rounded as the TPU kernel rounds them;
    // slot gl = lp (group pa + lp) or pb + lp (group half + pa + lp)
    for (int e = tid; e < 2 * np * mt * BN; e += THREADS) {
        const int c = e % BN;
        const int mm = (e / BN) % mt;
        const int glc = e / (BN * mt);
        const int gl = (glc / np) * pb + glc % np;
        const int idx = (gl * mt + mm) * BN + c;
        terms_s[idx] = __fmul_rn((float)(dots_s[idx] >> 4),
                                 __fmul_rn(xs_s[mm * 2 * pb + gl], ws_s[gl * BN + c]));
    }
    __syncthreads();

    if (splits == 1) {
        // every group is here (pb = half): fold in group order, low then high
        for (int e = tid; e < mt * BN; e += THREADS) {
            const int c = e % BN;
            const int mm = e / BN;
            if (n0 + c >= n) continue;
            float a = 0.0f;
#pragma unroll 8
            for (int gl = 0; gl < 2 * pb; ++gl) a = __fadd_rn(a, terms_s[gl * mt * BN + e]);
            out[out_index<MOE>(m0 + mm, n0 + c, m, n, rows)] = __float2bfloat16(a);
        }
        return;
    }

    // split K: each term goes to the shared memory of the rank that folds
    // its column (4 columns a store, through distributed shared memory);
    // after the cluster's barrier each rank folds its columns' terms in
    // group order, every group from its own shared memory
    cg::cluster_group cluster = cg::this_cluster();
    const int cols = fold_cols(BN, splits);
    float* fold_s = reinterpret_cast<float*>(smem + lay.fold);      // [n_groups][mt][cols]
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
    for (int e = tid; e < 2 * np * mt * (BN / 4); e += THREADS) {
        const int c = 4 * (e % (BN / 4));
        const int mm = (e / (BN / 4)) % mt;
        const int glc = e / ((BN / 4) * mt);
        const int hh = glc / np;
        const int lp = glc % np;
        if (n0 + c >= n) continue;
        const float4 t = *reinterpret_cast<const float4*>(
            terms_s + ((hh * pb + lp) * mt + mm) * BN + c);
        float* at = fold_s + ((hh * half + pa + lp) * mt + mm) * cols + c % cols;
        *cluster.map_shared_rank(reinterpret_cast<float4*>(at), c / cols) = t;
    }
    cluster.sync();                                   // every term is in place
    const int c0 = blockIdx.y * cols;                 // this rank's first column
    for (int e = tid; e < mt * cols; e += THREADS) {
        const int cl = e % cols;
        const int mm = e / cols;
        if (c0 + cl >= BN || n0 + c0 + cl >= n) continue;
        const float* at = fold_s + mm * cols + cl;
        float a = 0.0f;
#pragma unroll 8
        for (int g = 0; g < n_groups; ++g) a = __fadd_rn(a, at[g * mt * cols]);
        out[out_index<MOE>(m0 + mm, n0 + c0 + cl, m, n, rows)] = __float2bfloat16(a);
    }
}

// The launch's shape: its shared memory and its grid, for rows_per_block
// output rows a block (M_CHUNK for the dense product, 1 for the expert
// one). Returns 0, or cudaErrorInvalidValue where the plan is not one the
// kernel takes (more than MAX_CLUSTER ranks, or too much shared memory).
template <int CG>
int s8_shape(int m, int k, int n, int n_groups, int pb, int rows_per_block, int& smem_bytes,
             dim3& grid) {
    constexpr int BN = COL_LANES * 4 * CG;
    const int half = n_groups / 2;
    const int splits = (half + pb - 1) / pb;
    const int mt = m < rows_per_block ? m : rows_per_block;
    if (splits > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    const Layout lay(mt, pb, k / n_groups, BN, n_groups, splits);
    if (lay.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
    smem_bytes = lay.bytes;
    grid = dim3((n + BN - 1) / BN, splits, (m + rows_per_block - 1) / rows_per_block);
    return 0;
}

// The launch of `grid` with `smem` bytes of dynamic shared memory on
// `stream`: where grid.y > 1, in clusters of grid.y blocks along y (the
// attribute kept in `attr`).
inline cudaLaunchConfig_t s8_config(dim3 grid, int smem, cudaStream_t stream,
                                    cudaLaunchAttribute& attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = grid.y;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = grid.y > 1 ? 1 : 0;
    return cfg;
}

}  // namespace
