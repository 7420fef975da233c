// W4A8 matmul (int8 activations with per-group scales × grouped int4
// weights) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel scripts/profile_llm_ops.py: s8g4_matmul (body
// _s8g4_kernel, pallas_call at :160), the LLM-ops profiler's grouped-int4
// prototype. Its math is that of int4_matmul_s8 (ops/quant.py): xq (M, K)
// int8 with scales xs (M, n_groups) f32; the weight packed (K/2, N) int8,
// low nibble row r, high nibble row r + K/2, sign-extended, scales ws
// (n_groups, N) f32. For each group g (G = K/n_groups rows) an exact s32
// dot d_g = Σ xq·w, then, groups in order, acc = acc + f32(d_g) · (xs[m,
// g] · ws[g, n]) in f32; out bf16. Bit-equal to its plain version.
//
// What bounds it on the H100: on the profiler's path M = 1, a GEMV that
// reads every packed weight byte once (2 nibbles, 4 operations): HBM-
// bound. A 3072 × 8192 projection is 12.6 MB of nibbles + 0.8 MB of
// scales → 4.0 µs at 3.35 TB/s.
//
// Design: two regimes behind one entry point; make_plan picks one from
// (M, K, N, n_groups) and is mirrored by
// scripts/profile_llm_ops.py:s8g4_plan.
//
// M ≤ 16, the profiler's path: the split-K GEMV of gemv_mma.cuh on the
// nibble planes. A K step is 32 packed rows; lane (g, t) streams its 16
// columns × 8 packed rows with 16-byte loads (L1 no-allocate), two steps
// in flight at M ≤ 8, and transposes them into the A fragments of the
// weight-as-A products (gemv_fragments). Each transposed word gives two
// planes, (w << 4) & 0xF0F0F0F0 for the low nibbles and w & 0xF0F0F0F0
// for the high ones: 16 times the signed nibble in every byte, so the
// int8 mma.sync m16n8k32 takes them as they are and the exact s32 dot is
// shifted back by 4. The low plane runs against x's group-p bytes and the
// high plane against its group-(p + n_groups/2) bytes: a packed row feeds
// two products and every weight byte is read once. K is split by group
// pairs (the G/32 steps whose low nibbles are group p and high nibbles
// group p + n_groups/2): the ranks of a cluster (gemv_split's size, held
// to a power of two, to the pairs, and to the clusters the card holds at
// once; raised where shared memory would not hold a rank's dots) take
// contiguous runs of pairs, and the 8 warps of a block take the rank's
// steps in turn. The s32 accumulators live for one step (one group) and
// go to shared memory one plane at a time, so a thread holds 32 of them
// at M ≤ 8 and two blocks fit an SM (128 registers). Meanwhile the
// rank's xs and ws tiles arrive by 4-byte cp.async. After one block
// barrier a warp takes a (group, plane), a lane four columns: the G/32
// step dots summed (exact), the terms f32(d) · (xs · ws) (__fmul_rn: no
// FMA) stored into the shared memory of the rank that folds those
// columns (rank r folds columns [r·128/split, (r+1)·128/split)), through
// distributed shared memory. After one cluster barrier each output adds
// its n_groups terms in group order 0 .. n_groups − 1 with __fadd_rn from
// its own shared memory. No atomics, nothing but the output written to
// device memory.
//
// M > 16, and where no split lets two GEMV blocks share an SM (M = 8
// at 3072 → 8192, M = 16 at K = 3072): the first design, kept. int8 mma
// on the tensor cores (m16n8k32, M padded to 16 by masking), one pass.
// One block of 8 warps takes 32 columns and a 16-row tile of M and walks
// the group pairs in chunks of 8: warp w takes pair p, reads each packed
// row once as 4x4 byte blocks transposed with __byte_perm
// (int8_blocks.cuh), splits the two nibble planes with a per-byte sign
// extension, and runs G/32 mma steps into one s32 accumulator set per
// plane. After those steps it writes each group's term f32(d) · (xs · ws)
// to shared memory. The low groups' terms are added to the running f32
// sums in group order after each chunk; the high groups' terms stay in
// shared memory for the whole sweep and are added, in order, after the
// last chunk, for (n_groups/2 + 8) · 16 · 32 f32 of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemv_mma.cuh"
#include "int8_blocks.cuh"

namespace {

constexpr int BN = 32;               // columns per block: four n8 tiles
constexpr int BM = 16;               // rows of M per block: the mma's M
constexpr int WARPS = 8;             // group pairs in flight
constexpr int THREADS = 32 * WARPS;
constexpr int PER_THREAD = BM * BN / THREADS;   // running sums a thread keeps

// the signed nibbles of 4 packed bytes (low plane: shift 0, high: 4), one
// s8 a byte: per-byte (v ^ 8) - 8 sign-extends a 4-bit v
__device__ __forceinline__ unsigned nibbles(unsigned packed, int shift) {
    return __vsub4(((packed >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// one pair's s32 dots of a group → its f32 terms f32(d) · (xs · ws) at
// dst (mt, BN), for the tile's real rows
__device__ __forceinline__ void write_terms(const int c[4][4], int gi, float* dst,
                                            const float* xs, const float* ws, int m, int n,
                                            int n_groups, int m0, int n0, int g, int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e / 2);
        if (m0 + r >= m) continue;
        const float x_scale = xs[(long long)(m0 + r) * n_groups + gi];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = acc_column(j, e, t);
            const float w_scale = n0 + col < n ? ws[(long long)gi * n + n0 + col] : 0.0f;
            dst[r * BN + col] = __fmul_rn((float)c[j][e], __fmul_rn(x_scale, w_scale));
        }
    }
}

__global__ void __launch_bounds__(THREADS)
s8g4_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int m, int k, int n, int n_groups) {
    extern __shared__ float terms[];
    const int mt = min(BM, m);                       // rows the terms hold
    const int half = n_groups / 2;
    const int group = k / n_groups;
    float* hi_terms = terms;                         // (half, mt, BN): groups half..
    float* lo_terms = terms + (long long)half * mt * BN;   // (WARPS, mt, BN): a chunk

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;

    float acc[PER_THREAD];               // element tid + i·THREADS of (mt, BN)
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.0f;

    for (int p0 = 0; p0 < half; p0 += WARPS) {
        const int p = p0 + warp;
        if (p < half) {
            int c_lo[4][4], c_hi[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) c_lo[j][e] = c_hi[j][e] = 0;
            for (int s = 0; s < group; s += 32) {
                const int r = p * group + s;         // packed row of this k32 step
                unsigned b[4][2], a_lo[4], a_hi[4];
                load_b(w, k / 2, n, n0, r, g, t, b);
                load_a(xq, m, k, m0, r, g, t, a_lo);           // group p
                load_a(xq, m, k, m0, r + k / 2, g, t, a_hi);   // group p + half
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    mma_s8(c_lo[j], a_lo, nibbles(b[j][0], 0), nibbles(b[j][1], 0));
                    mma_s8(c_hi[j], a_hi, nibbles(b[j][0], 4), nibbles(b[j][1], 4));
                }
            }
            write_terms(c_lo, p, lo_terms + (long long)warp * mt * BN, xs, ws, m, n,
                        n_groups, m0, n0, g, t);
            write_terms(c_hi, p + half, hi_terms + (long long)p * mt * BN, xs, ws, m, n,
                        n_groups, m0, n0, g, t);
        }
        __syncthreads();
        // the chunk's low groups, in order
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int el = tid + i * THREADS;
            if (el < mt * BN)
                for (int q = 0; q < WARPS && p0 + q < half; ++q)
                    acc[i] = __fadd_rn(acc[i], lo_terms[q * mt * BN + el]);
        }
        __syncthreads();                 // the next chunk rewrites lo_terms
    }
    // then the high groups, in order
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int el = tid + i * THREADS;
        if (el >= mt * BN) continue;
        for (int p = 0; p < half; ++p)
            acc[i] = __fadd_rn(acc[i], hi_terms[(long long)p * mt * BN + el]);
        const int row = m0 + el / BN;
        const int col = n0 + el % BN;
        if (row < m && col < n) out[(long long)row * n + col] = __float2bfloat16(acc[i]);
    }
}

constexpr int GEMV_MAX_M = 16;           // rows of the GEMV regime: two n8 tiles of x
constexpr int GEMV_STEP = 32;            // packed rows a warp's step: the mma's depth
// shared memory a block may use with two blocks an SM: 228 KB less the
// 1 KB the card reserves a block, halved
constexpr size_t GEMV_SMEM = (228 * 1024 - 2 * 1024) / 2;
// blocks of this GEMV the H100 holds at once in clusters of 4 and of 8
// (cudaOccupancyMaxActiveClusters: 62 and 30 clusters, two blocks an SM);
// a grid above it runs a second wave
constexpr int CLUSTER4_BLOCKS = 248;
constexpr int CLUSTER8_BLOCKS = 240;

// The GEMV block's shared memory, as it lays it out: the s32 dots of its
// rank's steps (a group pair's spp = G/32 steps, the most pairs a rank of
// `split` holds), two nibble planes of m rows × GEMV_COLS each; the ws
// tile of the rank's groups; the terms of the columns the rank folds
// (GEMV_COLS / split of them, m rows, every group); the xs tile.
struct GemvLayout {
    int pairs, cols;
    size_t ws, stage, xs, bytes;
};

__host__ __device__ inline GemvLayout gemv_layout(int m, int n_groups, int spp, int split) {
    const int half = n_groups / 2;
    GemvLayout l;
    l.pairs = (half + split - 1) / split;
    l.cols = GEMV_COLS / split;
    l.ws = (size_t)l.pairs * spp * 2 * m * GEMV_COLS * sizeof(int);
    l.stage = l.ws + (size_t)2 * l.pairs * GEMV_COLS * sizeof(float);
    l.xs = l.stage + (size_t)n_groups * m * l.cols * sizeof(float);
    l.bytes = l.xs + (size_t)2 * l.pairs * m * sizeof(float);
    return l;
}

// mirrored by scripts/profile_llm_ops.py:s8g4_plan: the regime (1: the
// GEMV, 0: the 16-row mma tiles) and the GEMV's K split (cluster size, a
// power of two, over group pairs)
struct Plan {
    int gemv, split;
};

Plan make_plan(int m, int k, int n, int n_groups) {
    const int half = n_groups / 2;
    const int spp = k / n_groups / GEMV_STEP;     // steps a pair
    const int tiles = (n + GEMV_COLS - 1) / GEMV_COLS;
    if (m > GEMV_MAX_M) return {0, 1};
    auto fits = [&](int s) {                      // the card holds the grid at once
        return s < 4 || tiles * s <= (s == 4 ? CLUSTER4_BLOCKS : CLUSTER8_BLOCKS);
    };
    int split = gemv_split(k / 2 / GEMV_STEP, n);
    while (split > half || !fits(split)) split /= 2;
    while (gemv_layout(m, n_groups, spp, split).bytes > GEMV_SMEM &&
           2 * split <= GEMV_MAX_SPLIT && 2 * split <= half && fits(2 * split))
        split *= 2;
    if (gemv_layout(m, n_groups, spp, split).bytes > GEMV_SMEM) return {0, 1};
    return {1, split};
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// one plane's dots (16 times the nibbles', shifted back: exact) into dst
// (m, GEMV_COLS): rows < m, or row 0 alone for ONE_ROW (lanes t = 0,
// accumulators e = 0, 2)
template <int NT, bool ONE_ROW>
__device__ __forceinline__ void flush(const int (&acc)[NT][8][4], int* dst, int m, int g,
                                      int t) {
    if (ONE_ROW) {
        if (t == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                dst[16 * g + 2 * j] = acc[0][j][0] >> 4;
                dst[16 * g + 2 * j + 1] = acc[0][j][2] >> 4;
            }
        }
        return;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = 8 * nt + 2 * t + (e & 1);
                if (row < m) dst[row * GEMV_COLS + 16 * g + 2 * j + (e >> 1)] = acc[nt][j][e] >> 4;
            }
}

template <int NT, bool WIDE, bool ONE_ROW>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
s8g4_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ ws,
                 __nv_bfloat16* __restrict__ out, int m, int k, int n, int n_groups) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int DEPTH = NT == 1 ? 2 : 1;         // steps whose loads a warp keeps in flight
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int half = n_groups / 2;
    const int kh = k / 2;                          // packed rows
    const int spp = k / n_groups / GEMV_STEP;
    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const GemvSlice slice = gemv_slice(half);      // this rank's pairs [begin, end)
    const int pairs = slice.end - slice.begin;
    const GemvLayout lay = gemv_layout(m, n_groups, spp, split);
    const int plane_size = m * GEMV_COLS;
    int* dots = reinterpret_cast<int*>(smem);                    // (pairs·spp, 2, m, COLS)
    float* ws_s = reinterpret_cast<float*>(smem + lay.ws);       // (2, pairs, COLS)
    float* stage = reinterpret_cast<float*>(smem + lay.stage);   // (n_groups, m, cols)
    float* xs_s = reinterpret_cast<float*>(smem + lay.xs);       // (2, pairs, m)
    const int col = slice.n0 + 16 * g;

    // the rank's scales, in flight during the sweep: a warp a (plane,
    // pair) row of ws, then the xs column
    for (int q = warp; q < 2 * pairs; q += GEMV_WARPS) {
        const int plane = q >= pairs;
        const int lp = q - plane * pairs;
        const float* src = ws + (size_t)(slice.begin + lp + plane * half) * n + slice.n0;
        float* dst = ws_s + (plane * lay.pairs + lp) * GEMV_COLS;
        for (int c = lane; c < GEMV_COLS && slice.n0 + c < n; c += 32) cp_async4(dst + c, src + c);
    }
    for (int e = threadIdx.x; e < 2 * pairs * m; e += GEMV_THREADS) {
        const int q = e / m;
        const int row = e - q * m;
        const int plane = q >= pairs;
        const int lp = q - plane * pairs;
        cp_async4(xs_s + (plane * lay.pairs + lp) * m + row,
                  xs + (size_t)row * n_groups + slice.begin + lp + plane * half);
    }

    // the sweep: step s of the rank's pair lp is item lp·spp + s; warp w
    // takes items w, w + 8, ...; each item's two planes go to shared memory
    const int items = pairs * spp;
    for (int i0 = warp; i0 < items; i0 += DEPTH * GEMV_WARPS) {
        uint4 wv[DEPTH][8];
        unsigned b[DEPTH][NT][4];                  // x at the low and the high rows
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
            const int it = i0 + d * GEMV_WARPS;
            const bool live = it < items;
            const int r0 = (slice.begin * spp + it) * GEMV_STEP + 8 * t;
#pragma unroll
            for (int x = 0; x < 8; ++x)
                wv[d][x] = gemv_row16<WIDE>(w, live ? r0 + x : kh, col, kh, n);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int row = 8 * nt + g;
                const int8_t* p = xq + (size_t)row * k + r0;
                const bool ok = live && row < m;
                b[d][nt][0] = load4(p, ok);
                b[d][nt][1] = load4(p + 4, ok);
                b[d][nt][2] = load4(p + kh, ok);
                b[d][nt][3] = load4(p + kh + 4, ok);
            }
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
            const int it = i0 + d * GEMV_WARPS;
            if (it >= items) break;
            unsigned a[8][4];
            gemv_fragments(wv[d], a);
#pragma unroll
            for (int plane = 0; plane < 2; ++plane) {
                int acc[NT][8][4];
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    unsigned x[4];                 // 16 × the plane's signed nibbles
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        x[q] = (plane == 0 ? a[j][q] << 4 : a[j][q]) & 0xF0F0F0F0u;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
                        mma_s8(acc[nt][j], x, b[d][nt][2 * plane], b[d][nt][2 * plane + 1]);
                }
                flush<NT, ONE_ROW>(acc, dots + (size_t)(it * 2 + plane) * plane_size, m, g, t);
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // the scales
    __syncthreads();

    // a warp a (plane, pair), a lane four (row, column)s: the pair's spp
    // step dots summed (exact), its group's terms, stored in the shared
    // memory of the rank that folds those columns (rank c / cols)
    const int cols_log2 = __ffs(lay.cols) - 1;
    for (int q = warp; q < 2 * pairs; q += GEMV_WARPS) {
        const int plane = q >= pairs;
        const int lp = q - plane * pairs;
        const int gi = slice.begin + lp + plane * half;
        const int* dq = dots + (size_t)(lp * spp * 2 + plane) * plane_size;
        const float* wsr = ws_s + (plane * lay.pairs + lp) * GEMV_COLS;
        const float* xsr = xs_s + (plane * lay.pairs + lp) * m;
        for (int rc = 4 * lane; rc < plane_size; rc += 128) {
            const int c = rc % GEMV_COLS;
            const int row = rc / GEMV_COLS;
            if (slice.n0 + c >= n) continue;
            int4 d = make_int4(0, 0, 0, 0);
            for (int s = 0; s < spp; ++s) {
                const int4 v = *reinterpret_cast<const int4*>(dq + (size_t)s * 2 * plane_size + rc);
                d.x += v.x;
                d.y += v.y;
                d.z += v.z;
                d.w += v.w;
            }
            const float xv = xsr[row];
            const float4 wv4 = *reinterpret_cast<const float4*>(wsr + c);
            const float4 term = make_float4(__fmul_rn((float)d.x, __fmul_rn(xv, wv4.x)),
                                            __fmul_rn((float)d.y, __fmul_rn(xv, wv4.y)),
                                            __fmul_rn((float)d.z, __fmul_rn(xv, wv4.z)),
                                            __fmul_rn((float)d.w, __fmul_rn(xv, wv4.w)));
            float* at = stage + (gi * m + row) * lay.cols + (c & (lay.cols - 1));
            *cluster.map_shared_rank(reinterpret_cast<float4*>(at), c >> cols_log2) = term;
        }
    }
    cluster.sync();                                // every term is in place

    // this rank's columns, each output its terms in group order
    for (int o = threadIdx.x; o < m * lay.cols; o += GEMV_THREADS) {
        const int row = o >> cols_log2;
        const int cl = o & (lay.cols - 1);
        const int c = slice.n0 + rank * lay.cols + cl;
        if (c >= n) continue;
        const float* at = stage + row * lay.cols + cl;
        float acc = 0.0f;
#pragma unroll 8
        for (int gi = 0; gi < n_groups; ++gi) acc = __fadd_rn(acc, at[gi * m * lay.cols]);
        out[(size_t)row * n + c] = __float2bfloat16(acc);
    }
}

}  // namespace

// Dynamic shared memory of an mma-tile launch: the high groups' terms and
// one chunk of low groups' terms.
static size_t terms_bytes(int m, int n_groups) {
    const int mt = m < BM ? m : BM;
    return (size_t)(n_groups / 2 + WARPS) * mt * BN * sizeof(float);
}

template <int NT, bool ONE_ROW>
cudaError_t launch_gemv(bool wide, int split, cudaStream_t st, const int8_t* xq,
                        const float* xs, const int8_t* w, const float* ws, __nv_bfloat16* out,
                        int m, int k, int n, int n_groups) {
    const int smem = (int)gemv_layout(m, n_groups, k / n_groups / GEMV_STEP, split).bytes;
    return wide ? gemv_launch(s8g4_gemv_kernel<NT, true, ONE_ROW>, n, split, smem, st, xq, xs,
                              w, ws, out, m, k, n, n_groups)
                : gemv_launch(s8g4_gemv_kernel<NT, false, ONE_ROW>, n, split, smem, st, xq, xs,
                              w, ws, out, m, k, n, n_groups);
}

// xq (m, k) int8, xs (m, n_groups) f32, w (k/2, n) packed int8, ws
// (n_groups, n) f32, out (m, n) bf16; all dense, n a multiple of 4,
// n_groups even and dividing k, k / n_groups a multiple of 32.
// Returns the launch's error, or cudaGetLastError() after it.
extern "C" int tww_s8g4_matmul(const void* xq, const void* xs, const void* w, const void* ws,
                               void* out, int m, int k, int n, int n_groups, void* stream) {
    const Plan p = make_plan(m, k, n, n_groups);
    const auto xq8 = static_cast<const int8_t*>(xq);
    const auto xsf = static_cast<const float*>(xs);
    const auto w8 = static_cast<const int8_t*>(w);
    const auto wsf = static_cast<const float*>(ws);
    const auto ob = static_cast<__nv_bfloat16*>(out);
    const cudaStream_t st = (cudaStream_t)stream;
    if (p.gemv) {
        const bool wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
        const cudaError_t err =
            m == 1   ? launch_gemv<1, true>(wide, p.split, st, xq8, xsf, w8, wsf, ob, m, k, n,
                                                n_groups)
            : m <= 8 ? launch_gemv<1, false>(wide, p.split, st, xq8, xsf, w8, wsf, ob, m, k, n,
                                             n_groups)
                     : launch_gemv<2, false>(wide, p.split, st, xq8, xsf, w8, wsf, ob, m, k, n,
                                             n_groups);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaGetLastError();
    }
    const size_t smem = terms_bytes(m, n_groups);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            s8g4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    s8g4_matmul_kernel<<<grid, THREADS, smem, st>>>(xq8, xsf, w8, wsf, ob, m, k, n, n_groups);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_s8g4_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
