// Weight-only int8 matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/quant.py:
// int8_matmul (body _q_matmul_kernel, pallas_call at :62):
// out = x @ W with W[k, n] = bf16(bf16(w_q[k, n]) · bf16(scale[n])), the
// product rounded once to bf16, bf16 operands, f32 sums, bf16 out.
//
// Design: two regimes behind one entry point; make_plan picks one from
// (M, K, N) and is mirrored by ops/quant.py:int8_plan.
//
// Decode rows, M ≤ GEMV_MAX_M: HBM-bound. At M = 1 every weight byte is
// read once for 2 operations: the 8B lm_head (4096 × 128256, 525 MB)
// takes at least 0.157 ms at 3.35 TB/s, a 3072 × 8192 projection 7.5 µs.
// The split-K GEMV of gemv_mma.cuh: a lane streams 16 columns × 4 rows a
// K step with 16-byte loads, two steps in flight, and dequantizes them
// in registers with one byte permute and one fused multiply-add a weight
// (`weight`, exact), rounded once to bf16 by the pair conversion that
// also packs the mma.sync m16n8k16 A fragment; x's rows are the B
// fragment, read as 8 bytes (4 bf16 of one row) a lane and a step. The
// tensor cores take the products, so the instructions a weight byte
// costs do not grow with M. K is split over a cluster where the column
// tiles do not fill the card (3072 → 1024: 8 tiles, 8 ranks).
//
// Prefill rows, M > GEMV_MAX_M: tensor-core bound. At M = 512 the 8B
// lm_head does 2·M·K·N = 538 GFLOP on 0.54 GB of weights, about 1000
// operations a byte: 0.544 ms at 989 TFLOP/s. The wgmma ring of
// wgmma_ring.cuh (int4_matmul.cu's design): one block per 256 × 128
// output tile, two consumer warpgroups on wgmma m64n128k16 and two
// producer warpgroups (the registers moved to the consumers by
// setmaxnreg). A producer thread issues 16-byte cp.async copies of x (A,
// 64 columns a chunk, in the 128-byte swizzle) and of 2 rows × 16 columns
// of the chunk's 64 × 128 weight bytes a chunk ahead, then dequantizes
// those very bytes into B (MN-major, two 64-column panels) with `weight`,
// its 16 columns' terms held in registers for the whole K, so the
// producers share no barrier. The 256-row tile halves the dequantization
// a product against 128 rows. K is split over a cluster only where the
// tiles number fewer than 132.
//
// Ragged M, N and K are masked in the kernels (zeros in, no store out),
// so the wrapper makes no padded copy of the 525 MB head, which the JAX
// wrapper pads on every call when N is not a multiple of 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemv_mma.cuh"
#include "wgmma_ring.cuh"

namespace {

constexpr int GEMV_MAX_M = 8;            // rows of the decode regime: one n8 tile of x
constexpr int GEMV_STEP = 16;            // K rows a warp's step: the mma's depth
constexpr int GEMV_UNROLL = 2;           // steps whose loads a warp keeps in flight
constexpr int GEMV_SMEM = GEMV_WARPS * 8 * GEMV_COLS * 4;   // the fold's f32 partials

// two producer warpgroups: the dequantization, not the products, bounds
// the ring with one; the registers move to the consumers (setmaxnreg)
constexpr int PRODUCERS = 256;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int PRODUCER_REGS = 72;
constexpr int CONSUMER_REGS = 184;
static_assert(CONSUMERS * CONSUMER_REGS + PRODUCERS * PRODUCER_REGS <= 65536,
              "the register file holds both roles");
constexpr int BK = 64;                   // K rows per chunk of the ring
constexpr int STAGES = 4;
// chunks whose copies are in flight ahead of the one being dequantized;
// the producers may run STAGES − AHEAD − 1 chunks ahead of the consumers
constexpr int AHEAD = 1;
constexpr int RPT = BK * (BN / 16) / PRODUCERS;   // rows of 16 bytes a producer thread takes
constexpr int W_BYTES = BK * BN;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES + W_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + 1024-byte alignment

static_assert(STAGES - AHEAD - 1 >= 1, "the producer runs a chunk ahead of the consumers");
static_assert(BM * PART_LD * 4 <= STAGES * STAGE_BYTES, "the partial tile reuses the ring");
static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles are 1024-byte aligned");
static_assert(SMEM_BYTES + 1024 <= MAX_BLOCK_SMEM, "the ring fits one block's shared memory");

// mirrored by ops/quant.py:int8_plan: the regime (1: the GEMV, 0: the
// wgmma ring) and its K split (cluster size)
struct Plan {
    int gemv, split;
};

Plan make_plan(int m, int k, int n) {
    if (m <= GEMV_MAX_M) return {1, gemv_split((k + GEMV_STEP - 1) / GEMV_STEP, n)};
    return {0, ring_split(m, n, (k + BK - 1) / BK)};
}

// The TPU kernel's weight, bf16(byte × bf16(scale)), in two instructions
// and half a conversion: byte j of u (the signed byte offset by 128) is
// placed in bits 8..15 under the exponent of 2^23, which makes the exact
// float 2^23 + 256·u, and one fused multiply-add with s2 = scale / 256
// and c = −(2^15 + 2^7)·scale gives (u − 128)·scale = byte × scale:
// every term is exact (c has 9 by 8 significant bits) and so is the sum,
// which has at most 16; the pair conversion then rounds it once to bf16.
struct Dequant {
    float s2, c;
};

__device__ __forceinline__ Dequant dequant_terms(const float* scale, int col, int n) {
    const float s = col < n ? __bfloat162float(__float2bfloat16(scale[col])) : 0.0f;
    return {s * 0.00390625f, s * -32896.0f};
}

__device__ __forceinline__ float weight(uint32_t u, int j, Dequant d) {
    return fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7504 + 16 * j)), d.s2, d.c);
}

// c (16x8 f32) += a (16x16 bf16, row-major) · b (16x8 bf16, K-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Decode rows: the split-K GEMV

// Lane (g, t) of a step at row k0 holds the weight rows k0 + 4t + i
// (i < 4) of its 16 columns; the mma's depth index {2t, 2t+1, 2t+8,
// 2t+9} stands for rows k0 + 4t + {0, 1, 2, 3}, so x's B fragment is the
// 4 bf16 at x[g, k0 + 4t ..] (b0 the first pair, b1 the second).
template <bool WIDE>
__global__ void __launch_bounds__(GEMV_THREADS)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 int m, int k, int n) {
    extern __shared__ float red[];           // GEMV_WARPS × 8 × GEMV_COLS, the fold
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const GemvSlice slice = gemv_slice((k + GEMV_STEP - 1) / GEMV_STEP);
    const int col = slice.n0 + 16 * g;
    Dequant d[16];                           // the lane's columns' terms
#pragma unroll
    for (int c = 0; c < 16; ++c) d[c] = dequant_terms(scale, col + c, n);
    const __nv_bfloat16* x_row = x + (size_t)(g < m ? g : 0) * k;

    float acc[1][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;

    for (int s0 = slice.begin + warp; s0 < slice.end; s0 += GEMV_WARPS * GEMV_UNROLL) {
        uint4 wv[GEMV_UNROLL][4];
        uint2 xv[GEMV_UNROLL];
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {     // every load first
            const int step = s0 + u * GEMV_WARPS;
            const int r0 = step * GEMV_STEP + 4 * t;
            const bool live = step < slice.end;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                wv[u][i] = live ? gemv_row16<WIDE>(w, r0 + i, col, k, n)
                                : make_uint4(0u, 0u, 0u, 0u);
            xv[u] = live && g < m && r0 < k
                        ? __ldg(reinterpret_cast<const uint2*>(x_row + r0))
                        : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {           // columns 4q .. 4q + 3
                uint32_t b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) b[i] = gemv_word(wv[u][i], q) ^ 0x80808080u;
#pragma unroll
                for (int h = 0; h < 2; ++h) {       // product j = 2q + h: columns 4q + 2h, + 1
                    const int c = 4 * q + 2 * h;
                    const uint32_t a[4] = {
                        pack_bf16(weight(b[0], 2 * h, d[c]), weight(b[1], 2 * h, d[c])),
                        pack_bf16(weight(b[0], 2 * h + 1, d[c + 1]), weight(b[1], 2 * h + 1, d[c + 1])),
                        pack_bf16(weight(b[2], 2 * h, d[c]), weight(b[3], 2 * h, d[c])),
                        pack_bf16(weight(b[2], 2 * h + 1, d[c + 1]), weight(b[3], 2 * h + 1, d[c + 1]))};
                    mma_bf16(acc[0][2 * q + h], a, xv[u].x, xv[u].y);
                }
            }
        }
    }
    gemv_fold<1>(acc, red, m, slice.n0, n, [&](int row, int c, float sum) {
        out[(size_t)row * n + c] = __float2bfloat16(sum);
    });
}

// ---------------------------------------------------------------------------
// Prefill rows: wgmma on tiles the producer warpgroup dequantizes

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
int8_ring_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 int m, int k, int n) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full_bar[STAGES];
    __shared__ __align__(8) uint64_t empty_bar[STAGES];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    // the f32 tile (BM, PART_LD), written over the ring once it is done
    float* part = reinterpret_cast<float*>(smem_raw + (base - raw));

    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int m0 = (blockIdx.x / split) * BM;
    const int n0 = blockIdx.y * BN;
    const int chunks = (k + BK - 1) / BK;
    const int c_begin = rank * chunks / split;
    const int n_local = (rank + 1) * chunks / split - c_begin;
    const int tid = threadIdx.x;

    ring_init<STAGES>(full_bar, empty_bar, PRODUCERS);

    if (tid >= CONSUMERS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS) : "memory");
        // ---- producer threads: copies, then dequantization ----
        // A thread copies, and then dequantizes, the same weight bytes: rows
        // w_row + W_ROWS·u (u < RPT) at columns n0 + 16q .. + 15, so it
        // waits for its own copies only and the producers need no barrier
        const int pt = tid - CONSUMERS;
        const int q = pt % 8;
        const int w_row = pt / 8;
        constexpr int W_ROWS = PRODUCERS / 8;
        const int col = n0 + 16 * q;
        Dequant d[16];                       // their terms, for the whole K
#pragma unroll
        for (int c = 0; c < 16; ++c) d[c] = dequant_terms(scale, col + c, n);
        // x copies, the same in every chunk but for k0: 16-byte chunk xc of
        // rows x_row + XROWS·u
        constexpr int XN = BM * 8 / PRODUCERS;
        constexpr int XROWS = PRODUCERS / 8;     // rows between a thread's copies
        static_assert(XROWS % 8 == 0 && W_ROWS % 8 == 0, "a thread's rows share their swizzle");
        const int xc = pt % 8;
        const int x_row = pt / 8;
        const __nv_bfloat16* x_src = x + (size_t)(m0 + x_row) * k + 8 * xc;
        // the swizzled chunk: x_row % 8 is the same for every copy
        const uint32_t x_dst = x_row * 128 + ((xc ^ (x_row % 8)) << 4);

        auto issue = [&](int j) {
            if (j < n_local) {
                const int st = j % STAGES;
                if (j >= STAGES)
                    mbar_wait(smem_addr(&empty_bar[st]), ((j / STAGES) - 1) & 1);
                const uint32_t a_s = base + st * STAGE_BYTES;
                const uint32_t w_s = a_s + A_BYTES + B_BYTES;
                const int k0 = (c_begin + j) * BK;
                const bool k_ok = k0 + 8 * xc < k;
#pragma unroll
                for (int u = 0; u < XN; ++u) {
                    const bool ok = k_ok && m0 + x_row + XROWS * u < m;
                    cp_async16(a_s + x_dst + XROWS * 128 * u,
                               ok ? x_src + (size_t)XROWS * u * k + k0 : x, ok ? 16u : 0u);
                }
#pragma unroll
                for (int u = 0; u < RPT; ++u) {
                    const int rr = w_row + W_ROWS * u;
                    if (k0 + rr >= k) continue;
                    const int8_t* src = w + (size_t)(k0 + rr) * n + col;
                    const uint32_t dst = w_s + rr * BN + 16 * q;
                    if (WIDE) {
                        if (col < n) cp_async16(dst, src, 16u);
                    } else {
#pragma unroll
                        for (int c = 0; c < 16; c += 4)
                            if (col + c < n) cp_async4(dst + c, src + c);
                    }
                }
            }
            cp_async_commit();
        };

        for (int j = 0; j < AHEAD; ++j) issue(j);
        for (int j = 0; j < n_local; ++j) {
            issue(j + AHEAD);
            cp_async_wait<AHEAD>();                  // chunk j's copies (this thread's)
            const int st = j % STAGES;
            const uint32_t a_s = base + st * STAGE_BYTES;
            const uint8_t* w_s = smem_raw + (a_s + A_BYTES + B_BYTES - raw);
            // B row rr, column chunks 2·(q % 4) and + 1 of panel q / 4
            uint8_t* panel = smem_raw + (a_s + A_BYTES - raw) + (q / 4) * (64 * 128);
            const int k0 = (c_begin + j) * BK;
#pragma unroll
            for (int u = 0; u < RPT; ++u) {
                const int rr = w_row + W_ROWS * u;
                uint4 lo = make_uint4(0u, 0u, 0u, 0u);
                uint4 hi = lo;
                if (k0 + rr < k) {
                    const uint4 wv = *reinterpret_cast<const uint4*>(w_s + rr * BN + 16 * q);
                    const uint32_t b[4] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u,
                                           wv.z ^ 0x80808080u, wv.w ^ 0x80808080u};
                    lo = make_uint4(pack_bf16(weight(b[0], 0, d[0]), weight(b[0], 1, d[1])),
                                    pack_bf16(weight(b[0], 2, d[2]), weight(b[0], 3, d[3])),
                                    pack_bf16(weight(b[1], 0, d[4]), weight(b[1], 1, d[5])),
                                    pack_bf16(weight(b[1], 2, d[6]), weight(b[1], 3, d[7])));
                    hi = make_uint4(pack_bf16(weight(b[2], 0, d[8]), weight(b[2], 1, d[9])),
                                    pack_bf16(weight(b[2], 2, d[10]), weight(b[2], 3, d[11])),
                                    pack_bf16(weight(b[3], 0, d[12]), weight(b[3], 1, d[13])),
                                    pack_bf16(weight(b[3], 2, d[14]), weight(b[3], 3, d[15])));
                }
                const int c2 = 2 * (q % 4);
                *reinterpret_cast<uint4*>(panel + rr * 128 + ((c2 ^ (rr % 8)) << 4)) = lo;
                *reinterpret_cast<uint4*>(panel + rr * 128 + (((c2 + 1) ^ (rr % 8)) << 4)) = hi;
            }
            // the copies and the stores, visible to wgmma (the async proxy)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(smem_addr(&full_bar[st]));
        }
        cp_async_wait<0>();
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS) : "memory");
        ring_consume<STAGES, STAGE_BYTES>(base, full_bar, empty_bar, n_local, part);
    }
    ring_fold_store(part, out, m0, n0, m, n);
}

}  // namespace

// x (m, k) bf16 16-byte aligned, w (k, n) int8, scale (n,) f32, out (m,
// n) bf16; all dense, k a multiple of 8 and n of 4. Returns the launch's
// error, or cudaGetLastError() after it.
extern "C" int tww_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                               int m, int k, int n, void* stream) {
    static bool raised[2] = {false, false};  // the ring's shared-memory attribute, once
    const Plan p = make_plan(m, k, n);
    const bool wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const auto xb = static_cast<const __nv_bfloat16*>(x);
    const auto wq = static_cast<const int8_t*>(w);
    const auto sc = static_cast<const float*>(scale);
    const auto ob = static_cast<__nv_bfloat16*>(out);
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (p.gemv) {
        err = wide ? gemv_launch(int8_gemv_kernel<true>, n, p.split, GEMV_SMEM, st, xb, wq, sc, ob,
                                 m, k, n)
                   : gemv_launch(int8_gemv_kernel<false>, n, p.split, GEMV_SMEM, st, xb, wq, sc,
                                 ob, m, k, n);
    } else {
        err = wide ? ring_launch(int8_ring_kernel<true>, raised[1], THREADS, SMEM_BYTES, m, n,
                                 p.split, st, xb, wq, sc, ob, m, k, n)
                   : ring_launch(int8_ring_kernel<false>, raised[0], THREADS, SMEM_BYTES, m, n,
                                 p.split, st, xb, wq, sc, ob, m, k, n);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* tww_int8_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
