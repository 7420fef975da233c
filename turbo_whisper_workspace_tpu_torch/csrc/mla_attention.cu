// Multi-head latent attention over the latent cache, the decode step, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU counterpart: the JAX package runs no MLA model. It serves the
// DeepSeek-V3 decode step (models/deepseek_v3.py, ops/mla_ops.py) in the
// absorbed form (DeepSeek-V2, arXiv:2405.04434, §2.1.3): the cache holds
// one 576-wide row a position, the normalized latent c_kv (512) and the
// rotated k_pe (64), and every query head attends over those rows with a
// 576-wide query, [q_nope · W_UK (512), rotated q_pe (64)]; the weights'
// sum of the rows' first 512 columns is the head's output latent, which
// the caller takes through W_UV. One launch also does the step's cache
// work: it rotates q_pe and k_pe by the RoPE tables at the position
// (half-split), and writes the new row [c_kv, rotated k_pe] at that
// position. The position is read from device memory (a CUDA graph freezes
// the launch), clamped to [0, S − 1]; t = 1 query row a batch row.
//
// What bounds it: at 16 heads the step reads each visible row once,
// 1152 bytes, and does 16 · (576 + 512) · 2 operations on it, ~30 per
// byte: below the card's ridge, so bytes; at 1800 positions 2.1 MB, 0.62
// µs at 3.35 TB/s. At one batch row that is a few SMs' worth of work, so
// what sets the time is the chain of dependent steps a block walks, and
// how fast a few SMs pull bytes (~45 GB/s an SM with 16 of them pulling).
// Design: one thread-block cluster of `ranks` blocks a (batch row, tile
// of 16 heads), 16 where the card holds every cluster of the launch at
// that size (the non-portable size, asked of the occupancy API once a
// process), else 8; rank r takes an equal slice of the pos + 1 visible
// rows. On entry every load that needs no position is in flight with the
// position's; then each rank puts its whole slice in flight: one bulk
// copy (the TMA's linear mode) a row into shared memory, at a padded
// stride, on an mbarrier per 32 rows. Up to RESIDENT rows (a slice up to
// S = 2560 at 16 ranks) stay resident and are used in one pass: the 16
// heads as the 16 rows of mma.sync m16n8k16 bf16 tiles, scores Q (16 ×
// 576, held in registers) · Kᵀ (each of 8 warps its 8-row tiles as their
// rows land, four chains of products), the slice's exact max, the weights
// exp2 (log2 e folded into the scale) rounded to bf16 for the product,
// their sums taken of the rounded values, then P (16 × rows) · V (each
// warp 64 of the 512 columns, V read by ldmatrix.trans). A longer slice
// streams through the same buffer in rounds of RESIDENT rows, with the
// online softmax's rescale between rounds. The ranks meet in distributed
// shared memory, all to all: once every rank is past its P·V (one cluster
// barrier), each pushes to rank c, by one bulk copy, its 16 heads' max and
// sum and its f32 partial sums of c's 512 / ranks columns; rank c combines
// its columns from what landed, every rank's share read at once. The rank
// whose slice holds the position patches the new row into its shared
// copy, so no block reads a row another block is writing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int LAT = 512;                   // the latent's width (kv_lora_rank)
constexpr int ROPE = 64;                   // the rope part's width
constexpr int ROW = LAT + ROPE;            // a cache row
constexpr int ROW_BYTES = ROW * 2;         // 1152: a bulk copy a row
constexpr int STRIDE = ROW + 8;            // a row in shared memory: 1168 B, no ldmatrix conflicts
constexpr int HEADS = 16;                  // query heads a block: the mma's 16 rows
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RESIDENT = 160;              // slice rows in shared memory at once
constexpr int GROUP = 32;                  // rows an mbarrier
constexpr int GROUPS = RESIDENT / GROUP;
constexpr int SSTRIDE = RESIDENT + 4;      // the scores' row (f32)
constexpr int PSTRIDE = RESIDENT + 8;      // the weights' row (bf16)
constexpr int QL = HEADS * LAT / 8 / THREADS;   // q_lat's 16-byte loads a thread
constexpr int QP = HEADS * ROPE / 2 / THREADS;   // q_pe's rotations a thread
constexpr int KEYS_PER_RANK = 64;          // the slice aimed at before the ranks are capped
constexpr int WIDE_RANKS = 16;             // the non-portable cluster size
constexpr int WAVE_BLOCKS = 132;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float M_INIT = -1e30f;           // the running max before any row: exp2 of a gap to it is 0

// shared memory, in bytes from the start
constexpr int Q_AT = 0;
constexpr int NEW_AT = Q_AT + HEADS * STRIDE * 2;
constexpr int BUF_AT = NEW_AT + STRIDE * 2;
constexpr int S_AT = BUF_AT + RESIDENT * STRIDE * 2;
constexpr int P_AT = S_AT + HEADS * SSTRIDE * 4;
constexpr int STAT_AT = P_AT + HEADS * PSTRIDE * 2;     // m, l, alpha: 3 × 16 f32
constexpr int BAR_AT = STAT_AT + 3 * HEADS * 4;        // GROUPS slice barriers, the combine's
constexpr int SMEM = BAR_AT + (GROUPS + 1) * 8;
// the combine, over the buffer: a rank's piece for rank c (the 16 heads'
// max and sum, then its partial sums of c's 512 / ranks columns, f32) is
// staged at c's place in STAGE and lands at the rank's place in c's RECV
constexpr int PIECES = 4 * (2 * HEADS * WIDE_RANKS + HEADS * LAT);   // a rank's, at most
constexpr int STAGE_AT = BUF_AT;
constexpr int RECV_AT = BUF_AT + PIECES;
static_assert(2 * PIECES <= RESIDENT * STRIDE * 2, "the combine's pieces fit the buffer");
static_assert(BUF_AT % 16 == 0 && BAR_AT % 8 == 0 && SMEM <= 232448, "shared memory layout");
static_assert(RESIDENT % 16 == 0 && QL * THREADS == HEADS * LAT / 8 &&
              QP * THREADS == HEADS * ROPE / 2 && THREADS % (ROPE / 2) == 0, "the loads a thread");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

// arrive once on `bar`, expecting `bytes` more to land on it (0 completes the phase)
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of `bar` with this parity; a copy that never lands
// traps (a launch error) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred P1;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
            "selp.u32 %0, 1, 0, P1;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 24)) __trap();
    }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// this block's shared address `addr` as the cluster address of the same
// place in rank `rank`'s shared memory
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

// `bytes` (a multiple of 16, 16-byte aligned) from this block's shared
// memory to another's (cluster addresses of the place and its barrier)
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the half-split rotation of a rope vector x (64 bf16) at one position,
// element j < 32 of it: x_j·cos_j − x_{j+32}·sin_j into out[0], x_{j+32}·cos_j
// + x_j·sin_j into out[32]; f32 products, one rounding (ops/llama_ops.apply_rope)
__device__ __forceinline__ void rotate(bf16 x_lo, bf16 x_hi, float c, float s, bf16* out) {
    const float x1 = __bfloat162float(x_lo), x2 = __bfloat162float(x_hi);
    out[0] = __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    out[ROPE / 2] = __float2bfloat16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

__global__ void __launch_bounds__(THREADS, 1)
mla_attention_kernel(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_pe,
                     long long q_pe_b, long long q_pe_h, const bf16* __restrict__ c_kv,
                     const bf16* __restrict__ k_pe, long long k_pe_b,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     bf16* __restrict__ cache, bf16* __restrict__ out, int n_head,
                     int head_tiles, int s_len, const long long* __restrict__ pos_at, int pos_i,
                     float scale) {
    extern __shared__ __align__(16) uint8_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int group = blockIdx.x / ranks;
    const int b = group / head_tiles;
    const int h0 = (group % head_tiles) * HEADS;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, c4 = lane % 4;

    // every load that needs no position, in flight with the position's:
    // thread i's 4 × 8 columns of q_lat, its 2 pairs of q_pe's halves (the
    // 16 heads' 32 rotations), 8 columns of c_kv, a pair of k_pe's
    long long p = pos_at != nullptr ? *pos_at : pos_i;
    uint4 ql[QL];
#pragma unroll
    for (int k = 0; k < QL; ++k) {
        const int i = tid + THREADS * k, h = i / (LAT / 8);
        ql[k] = h0 + h < n_head ? *reinterpret_cast<const uint4*>(
                                      q_lat + ((long long)b * n_head + h0 + h) * LAT + 8 * (i % (LAT / 8)))
                                : make_uint4(0, 0, 0, 0);
    }
    bf16 qp[QP][2];
#pragma unroll
    for (int k = 0; k < QP; ++k) {
        const int i = tid + THREADS * k, h = i / (ROPE / 2), j = i % (ROPE / 2);
        const bf16* x = q_pe + b * q_pe_b + (h0 + h) * q_pe_h;
        qp[k][0] = h0 + h < n_head ? x[j] : __float2bfloat16(0.0f);
        qp[k][1] = h0 + h < n_head ? x[j + ROPE / 2] : __float2bfloat16(0.0f);
    }
    const uint4 kv = tid < LAT / 8 ? *reinterpret_cast<const uint4*>(c_kv + (long long)b * LAT + 8 * tid)
                                   : make_uint4(0, 0, 0, 0);
    const bf16 kp0 = tid < ROPE / 2 ? k_pe[b * k_pe_b + tid] : __float2bfloat16(0.0f);
    const bf16 kp1 = tid < ROPE / 2 ? k_pe[b * k_pe_b + tid + ROPE / 2] : __float2bfloat16(0.0f);

    p = p < 0 ? 0 : (p > s_len - 1 ? s_len - 1 : p);
    const int pos = (int)p;
    const int n = pos + 1;                                // visible rows
    const int slice = (n + ranks - 1) / ranks;
    const int k_begin = min(rank * slice, n);
    const int count = min(k_begin + slice, n) - k_begin;  // this rank's rows
    const int rounds = (count + RESIDENT - 1) / RESIDENT;
    // the rotation tables' row, ahead of the slice's copies
    const float* cos_row = cos_t + (long long)pos * (ROPE / 2);
    const float* sin_row = sin_t + (long long)pos * (ROPE / 2);
    const float cs = cos_row[tid % (ROPE / 2)], sn = sin_row[tid % (ROPE / 2)];

    bf16* q_s = reinterpret_cast<bf16*>(smem + Q_AT);
    bf16* new_s = reinterpret_cast<bf16*>(smem + NEW_AT);
    bf16* buf = reinterpret_cast<bf16*>(smem + BUF_AT);
    float* s_s = reinterpret_cast<float*>(smem + S_AT);
    bf16* p_s = reinterpret_cast<bf16*>(smem + P_AT);
    float* m_s = reinterpret_cast<float*>(smem + STAT_AT);
    float* l_s = m_s + HEADS;
    float* alpha_s = l_s + HEADS;
    const uint32_t bars = smem_u32(smem + BAR_AT);
    const uint32_t buf_addr = smem_u32(buf);
    const bf16* cache_b = cache + (long long)b * s_len * ROW;

    // round r's rows [k_begin + RESIDENT·r, ...) into the buffer: thread 0
    // arms every barrier with its rows' bytes (each completes one phase a
    // round), lane l of warp w copies row 8l + w
    auto rows_of = [&](int r) { return min(count - r * RESIDENT, RESIDENT); };
    auto arm = [&](int r) {
        for (int i = 0; i < GROUPS; ++i)
            mbar_expect(bars + 8 * i, ROW_BYTES * max(0, min(rows_of(r) - GROUP * i, GROUP)));
    };
    auto copy = [&](int r) {
        const int i = 8 * lane + warp;                    // rows spread over the warps
        if (i < rows_of(r))
            bulk_copy(buf_addr + i * STRIDE * 2,
                      cache_b + (long long)(k_begin + r * RESIDENT + i) * ROW, ROW_BYTES,
                      bars + 8 * (i / GROUP));
    };
    const int cols = LAT / ranks;                         // the combine's columns a rank
    const int piece = 4 * (2 * HEADS + HEADS * cols);     // its bytes from each rank
    const uint32_t recv_bar = bars + 8 * GROUPS;
    if (tid == 0) {
        for (int i = 0; i <= GROUPS; ++i) mbar_init(bars + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (rounds > 0) arm(0);
        mbar_expect(recv_bar, ranks * piece);
    }
    __syncthreads();
    if (rounds > 0) copy(0);                              // the whole slice in flight

    // the query tile and the new row, rotated at the position
#pragma unroll
    for (int k = 0; k < QL; ++k) {
        const int i = tid + THREADS * k;
        *reinterpret_cast<uint4*>(q_s + (i / (LAT / 8)) * STRIDE + 8 * (i % (LAT / 8))) = ql[k];
    }
#pragma unroll
    for (int k = 0; k < QP; ++k) {
        const int i = tid + THREADS * k;
        rotate(qp[k][0], qp[k][1], cs, sn, q_s + (i / (ROPE / 2)) * STRIDE + LAT + i % (ROPE / 2));
    }
    if (tid < LAT / 8) *reinterpret_cast<uint4*>(new_s + 8 * tid) = kv;
    if (tid < ROPE / 2) rotate(kp0, kp1, cs, sn, new_s + LAT + tid);
    if (tid < HEADS) {
        m_s[tid] = M_INIT;
        l_s[tid] = 0.0f;
    }
    __syncthreads();
    const bool owner = k_begin <= pos && pos < k_begin + count;
    if (owner && h0 == 0) {                               // one block writes the row
        bf16* row = cache + ((long long)b * s_len + pos) * ROW;
        for (int i = tid; i < ROW / 8; i += THREADS)
            *reinterpret_cast<uint4*>(row + 8 * i) = *reinterpret_cast<const uint4*>(new_s + 8 * i);
    }

    const float scale2 = scale * LOG2E;
    float o[8][4];                                        // warp's 64 columns: 8 n-tiles
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    const uint32_t q_addr = smem_u32(q_s);
    const uint32_t p_addr = smem_u32(p_s);

    for (int r = 0; r < rounds; ++r) {
        const int r0 = k_begin + r * RESIDENT;            // the buffer's first row
        const int rows = rows_of(r);
        const int kt = (rows + 15) / 16 * 16;             // rows P·V takes, in k-steps of 16
        const uint32_t parity = r & 1;
        if (r > 0) {                                      // the last round is done with the buffer
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
            if (tid == 0) arm(r);
            copy(r);
        }

        // scores: warp w, the 8-row tiles w, w + 8, ... as their rows land
        uint32_t qf[ROW / 16][4];
#pragma unroll
        for (int ks = 0; ks < ROW / 16; ++ks)
            ldmatrix_x4(qf[ks], q_addr + 2 * ((lane % 16) * STRIDE + 16 * ks + 8 * (lane / 16)));
        for (int t = warp; 8 * t < rows; t += WARPS) {
            mbar_wait(bars + 8 * (8 * t / GROUP), parity);
            if (owner && r0 + 8 * t <= pos && pos < r0 + 8 * t + 8) {
                for (int i = lane; i < ROW / 8; i += 32)
                    *reinterpret_cast<uint4*>(buf + (pos - r0) * STRIDE + 8 * i) =
                        *reinterpret_cast<const uint4*>(new_s + 8 * i);
                __syncwarp();
            }
            float acc[4][4] = {};
            const uint32_t k_addr =
                buf_addr + 2 * ((8 * t + lane % 8) * STRIDE + 8 * (lane / 8));
#pragma unroll
            for (int kk = 0; kk < ROW / 16; kk += 2) {
                uint32_t bk[4];
                ldmatrix_x4(bk, k_addr + 2 * 16 * kk);
                const int c = 2 * ((kk / 2) % 2);
                mma_bf16(acc[c], qf[kk], bk[0], bk[1]);
                mma_bf16(acc[c + 1], qf[kk + 1], bk[2], bk[3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = 8 * t + 2 * c4 + (e & 1);
                const int head = g + 8 * (e >> 1);
                const float s = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
                s_s[head * SSTRIDE + key] = key < rows ? s * scale2 : -INFINITY;
            }
        }
        // every copy of the round has landed; the rows past the slice in
        // P·V's last k-step read as zeros
        for (int i = 0; i < GROUPS; ++i) mbar_wait(bars + 8 * i, parity);
        for (int i = tid; i < (kt - rows) * (LAT / 8); i += THREADS)
            *reinterpret_cast<uint4*>(buf + (rows + i / (LAT / 8)) * STRIDE + 8 * (i % (LAT / 8))) =
                make_uint4(0, 0, 0, 0);
        __syncthreads();

        // the slice's exact softmax: 16 threads a head, keys j, j + 16, ...
        {
            const int h = tid / 16, j = tid % 16;
            float v[RESIDENT / 16], mx = -INFINITY;
#pragma unroll
            for (int e = 0; e < RESIDENT / 16; ++e) {
                v[e] = j + 16 * e < rows ? s_s[h * SSTRIDE + j + 16 * e] : -INFINITY;
                mx = fmaxf(mx, v[e]);
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_old = m_s[h];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.0f;
#pragma unroll
            for (int e = 0; e < RESIDENT / 16; ++e) {
                if (j + 16 * e < kt) {
                    const bf16 pb = __float2bfloat16(j + 16 * e < rows ? exp2f(v[e] - m_new) : 0.0f);
                    p_s[h * PSTRIDE + j + 16 * e] = pb;
                    sum += __bfloat162float(pb);
                }
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            __syncwarp();
            if (j == 0) {
                const float alpha = exp2f(m_old - m_new);
                alpha_s[h] = alpha;
                l_s[h] = l_s[h] * alpha + sum;
                m_s[h] = m_new;
            }
        }
        __syncthreads();

        // P (16 × kt) · V: warp w, columns 64w..64w+63
        if (r > 0) {                                      // the online rescale between rounds
            const float a_lo = alpha_s[g], a_hi = alpha_s[g + 8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                o[j][0] *= a_lo;
                o[j][1] *= a_lo;
                o[j][2] *= a_hi;
                o[j][3] *= a_hi;
            }
        }
#pragma unroll 2
        for (int kk = 0; kk < kt / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, p_addr + 2 * ((lane % 16) * PSTRIDE + 16 * kk + 8 * (lane / 16)));
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                uint32_t bv[4];
                const int key = 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
                const int col = 64 * warp + 16 * jj + 8 * (lane / 16);
                ldmatrix_x4_trans(bv, buf_addr + 2 * (key * STRIDE + col));
                mma_bf16(o[2 * jj], a, bv[0], bv[1]);
                mma_bf16(o[2 * jj + 1], a, bv[2], bv[3]);
            }
        }
    }

    // the ranks meet in distributed shared memory: each stages its pieces
    // (columns XOR-swizzled by head, so the stores hit no bank twice) and,
    // once every rank is past its P·V, pushes piece c into rank c's RECV,
    // one bulk copy a rank; then it combines its columns from RECV alone
    __syncthreads();
    float* stage = reinterpret_cast<float*>(smem + STAGE_AT);
    const float* recv = reinterpret_cast<const float*>(smem + RECV_AT);
    const int piece_f = piece / 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int col = 64 * warp + 8 * j + 2 * c4;
        float* dst = stage + (col / cols) * piece_f + 2 * HEADS;
        const int at = (col % cols) ^ (8 * (g % 4));
        *reinterpret_cast<float2*>(dst + g * cols + at) = make_float2(o[j][0], o[j][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * cols + at) = make_float2(o[j][2], o[j][3]);
    }
    for (int i = tid; i < 2 * HEADS * ranks; i += THREADS)
        stage[(i / (2 * HEADS)) * piece_f + i % (2 * HEADS)] =
            i % (2 * HEADS) < HEADS ? m_s[i % HEADS] : l_s[i % HEADS];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cluster.sync();                                       // every RECV is free
    if (tid < ranks) {
        bulk_push(map_rank(smem_u32(smem + RECV_AT + rank * piece), tid),
                  smem_u32(smem + STAGE_AT + tid * piece), piece, map_rank(recv_bar, tid));
    }
    mbar_wait(recv_bar, 0);
    // every piece for this rank has landed, so its pushes into this rank
    // are done; no block leaves before all are (its STAGE is their source)
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
    // two columns a thread, every rank's share of its head
    const int pairs = cols / 2;
    for (int e = tid; e < HEADS * pairs; e += THREADS) {
        const int h = e / pairs, lc = 2 * (e % pairs);
        float m[WIDE_RANKS], l[WIDE_RANKS];
        float2 v[WIDE_RANKS];
#pragma unroll
        for (int c = 0; c < WIDE_RANKS; ++c) {
            const bool ok = c < ranks;
            const float* src = recv + c * piece_f;
            m[c] = ok ? src[h] : M_INIT;
            l[c] = ok ? src[HEADS + h] : 0.0f;
            v[c] = ok ? *reinterpret_cast<const float2*>(src + 2 * HEADS + h * cols +
                                                         (lc ^ (8 * (h % 4))))
                      : make_float2(0.0f, 0.0f);
        }
        float mx = m[0];
#pragma unroll
        for (int c = 1; c < WIDE_RANKS; ++c) mx = fmaxf(mx, m[c]);
        float total = 0.0f;
#pragma unroll
        for (int c = 0; c < WIDE_RANKS; ++c) {
            m[c] = exp2f(m[c] - mx);                      // each rank's share of the head
            total += m[c] * l[c];
        }
        float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int c = 0; c < WIDE_RANKS; ++c) {
            const float f = m[c] / total;
            acc.x += f * v[c].x;
            acc.y += f * v[c].y;
        }
        if (h0 + h < n_head)
            *reinterpret_cast<__nv_bfloat162*>(out + ((long long)b * n_head + h0 + h) * LAT +
                                               rank * cols + lc) = __floats2bfloat162_rn(acc.x, acc.y);
    }
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The kernel's attributes (its shared memory, clusters above the portable
// size), set once a process, and the 16-block clusters the card then holds
// at once (cudaOccupancyMaxActiveClusters; 0 where it holds none): {error
// of setting the attributes, clusters}
struct Wide {
    int err, clusters;
};

Wide wide_clusters() {
    static const Wide wide = [] {
        cudaError_t err = cudaFuncSetAttribute(
            mla_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(mla_attention_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return Wide{(int)err, 0};
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(WIDE_RANKS);
        cfg.blockDim = dim3(THREADS);
        cfg.dynamicSmemBytes = SMEM;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = WIDE_RANKS;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(&n, mla_attention_kernel, &cfg) != cudaSuccess) {
            cudaGetLastError();                           // not sticky: no wide clusters
            n = 0;
        }
        return Wide{0, n};
    }();
    return wide;
}

// ranks a cluster: the visible rows' slices of about KEYS_PER_RANK, no
// more than fill one wave, at most 16 where the card holds every cluster
// of the launch at that size, else 8 (the portable size); a power of two
int plan_ranks(int s_len, int clusters, int wide) {
    clusters = clusters > 0 ? clusters : 1;
    int ranks = (s_len + KEYS_PER_RANK - 1) / KEYS_PER_RANK;
    const int wave = WAVE_BLOCKS / clusters;
    const int cap = clusters <= wide ? WIDE_RANKS : MAX_RANKS;
    ranks = ranks < wave ? ranks : wave;
    ranks = ranks < cap ? ranks : cap;
    int p2 = 1;                                           // 512 / ranks columns each
    while (2 * p2 <= ranks) p2 *= 2;
    return p2;
}

}  // namespace

// q_lat (batch, n_head, 512) bf16; q_pe: the un-rotated rope part of the
// queries, 64 contiguous bf16 at q_pe + b·q_pe_b + h·q_pe_h (elements);
// c_kv (batch, 512) bf16, the new token's normalized latent; k_pe: its
// un-rotated rope part, 64 bf16 at k_pe + b·k_pe_b; cos, sin (table_rows,
// 32) f32; cache (batch, s_len, 576) bf16, written at the position; out
// (batch, n_head, 512) bf16. q_lat, c_kv, cache and out 16-byte aligned
// and dense; q_pe, k_pe 4-byte aligned. pos: an int64 in device memory at
// pos_at, or the host int `pos` when pos_at is null; clamped to [0,
// s_len − 1] (and below table_rows by the caller). Returns
// cudaGetLastError() after the launch (or the launch's own error).
extern "C" int tww_mla_attention(const void* q_lat, const void* q_pe, long long q_pe_b,
                                 long long q_pe_h, const void* c_kv, const void* k_pe,
                                 long long k_pe_b, const void* cos_t, const void* sin_t,
                                 void* cache, void* out, int batch, int n_head, int s_len,
                                 int table_rows, const void* pos_at, int pos, float scale,
                                 void* stream) {
    if (batch < 1 || n_head < 1 || s_len < 1 || table_rows < s_len)
        return (int)cudaErrorInvalidValue;
    const Wide wide = wide_clusters();
    if (wide.err) return wide.err;
    const int head_tiles = (n_head + HEADS - 1) / HEADS;
    const int ranks = plan_ranks(s_len, batch * head_tiles, wide.clusters);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * head_tiles * ranks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, mla_attention_kernel, static_cast<const bf16*>(q_lat),
        static_cast<const bf16*>(q_pe), q_pe_b, q_pe_h, static_cast<const bf16*>(c_kv),
        static_cast<const bf16*>(k_pe), k_pe_b, static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<bf16*>(cache), static_cast<bf16*>(out),
        n_head, head_tiles, s_len, static_cast<const long long*>(pos_at), pos, scale);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The ranks tww_mla_attention launches a cluster with, for the Python
// mirror's check (ops/mla_ops.py:ranks); -1 where the kernel's attributes
// are refused.
extern "C" int tww_mla_attention_ranks(int s_len, int clusters) {
    const Wide wide = wide_clusters();
    return wide.err ? -1 : plan_ranks(s_len, clusters, wide.clusters);
}

// The 16-block clusters of the kernel the card holds at once (the
// occupancy query's answer; 0: the kernel keeps 8 ranks), -1 as above.
extern "C" int tww_mla_attention_wide_clusters() {
    const Wide wide = wide_clusters();
    return wide.err ? -1 : wide.clusters;
}

extern "C" const char* tww_mla_attention_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
