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
// µs at 3.35 TB/s. Design: one thread-block cluster of `ranks` blocks a
// (batch row, tile of 16 heads); rank r takes an equal slice of the pos +
// 1 visible rows and streams it through shared memory in chunks of 64
// rows (a 2-deep cp.async ring), with the 16 heads as the 16 rows of
// mma.sync m16n8k16 bf16 tiles: scores Q (16 × 576) · Kᵀ (each of 8
// warps 8 rows of the chunk, in two chains of products), an online
// softmax in f32 (exp2 with log2 e folded into the scale; the weights
// rounded to bf16 for the product, their sums taken of the rounded
// values), then P (16 × 64) · V (each warp 64 of the 512 columns, V read
// from the same chunk by ldmatrix.trans). The
// ranks meet in distributed shared memory: each rescales every rank's
// partial sums by its max and takes 512 / ranks output columns. The rank
// whose slice holds the position patches the new row into its chunk
// from shared memory, so no block reads a row another block is writing.
// Not yet used: more than 8 ranks (B = 1 runs on 8 SMs), TMA.

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
constexpr int STRIDE = ROW + 8;            // a row in shared memory: 1168 B, no ldmatrix conflicts
constexpr int HEADS = 16;                  // query heads a block: the mma's 16 rows
constexpr int CHUNK = 64;                  // cache rows a ring stage: 8 a warp
constexpr int STAGES = 2;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PSTRIDE = CHUNK + 8;         // the weights' row in shared memory (bf16)
constexpr int SSTRIDE = CHUNK + 1;         // the scores' row (f32)
constexpr int KEYS_PER_RANK = 64;          // the slice aimed at before the ranks are capped
constexpr int WAVE_BLOCKS = 132;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float M_INIT = -1e30f;           // the running max before any row: exp2 of a gap to it is 0

// shared memory, in bytes from the start
constexpr int Q_AT = 0;
constexpr int NEW_AT = Q_AT + HEADS * STRIDE * 2;
constexpr int RING_AT = NEW_AT + STRIDE * 2;
constexpr int S_AT = RING_AT + STAGES * CHUNK * STRIDE * 2;
constexpr int P_AT = S_AT + HEADS * SSTRIDE * 4;
constexpr int STAT_AT = P_AT + HEADS * PSTRIDE * 2;     // m, l, alpha: 3 × 16 f32
constexpr int SMEM = STAT_AT + 3 * HEADS * 4;
static_assert(HEADS * LAT * 4 <= STAGES * CHUNK * STRIDE * 2, "the combine's partials fit the ring");

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
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

// the half-split rotation of a rope vector x (64 bf16) at one position:
// element i < 32 → x_i·cos_i − x_{i+32}·sin_i, element i + 32 → x_{i+32}·cos_i
// + x_i·sin_i, f32 products, one rounding (ops/llama_ops.apply_rope)
__device__ __forceinline__ void rotate(const bf16* x, const float* cos_row, const float* sin_row,
                                       int i, bf16* out) {
    const float x1 = __bfloat162float(x[i]), x2 = __bfloat162float(x[i + ROPE / 2]);
    const float c = cos_row[i], s = sin_row[i];
    out[i] = __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    out[i + ROPE / 2] = __float2bfloat16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

__global__ void __launch_bounds__(THREADS)
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

    long long p = pos_at != nullptr ? *pos_at : pos_i;
    p = p < 0 ? 0 : (p > s_len - 1 ? s_len - 1 : p);
    const int pos = (int)p;
    const int n = pos + 1;                                // visible rows
    const int slice = (n + ranks - 1) / ranks;
    const int k_begin = min(rank * slice, n);
    const int k_end = min(k_begin + slice, n);
    const int chunks = (k_end - k_begin + CHUNK - 1) / CHUNK;

    bf16* q_s = reinterpret_cast<bf16*>(smem + Q_AT);
    bf16* new_s = reinterpret_cast<bf16*>(smem + NEW_AT);
    bf16* ring = reinterpret_cast<bf16*>(smem + RING_AT);
    float* s_s = reinterpret_cast<float*>(smem + S_AT);
    bf16* p_s = reinterpret_cast<bf16*>(smem + P_AT);
    float* m_s = reinterpret_cast<float*>(smem + STAT_AT);
    float* l_s = m_s + HEADS;
    float* alpha_s = l_s + HEADS;
    const bf16* cache_b = cache + (long long)b * s_len * ROW;

    // a chunk's rows [k_begin + CHUNK·c, ...) into ring stage c % STAGES;
    // rows past k_end are zeros
    auto issue = [&](int c) {
        if (c < chunks) {
            const int r0 = k_begin + c * CHUNK;
            bf16* dst = ring + (c % STAGES) * CHUNK * STRIDE;
            for (int i = tid; i < CHUNK * (ROW / 8); i += THREADS) {
                const int r = i / (ROW / 8), col = 8 * (i % (ROW / 8));
                const bool ok = r0 + r < k_end;
                cp_async16_zfill((uint32_t)__cvta_generic_to_shared(dst + r * STRIDE + col),
                                 cache_b + (long long)(ok ? r0 + r : 0) * ROW + col, ok);
            }
        }
        cp_async_commit();
    };
    for (int c = 0; c < STAGES - 1; ++c) issue(c);

    // the query tile and the new row, rotated at the position
    const float* cos_row = cos_t + (long long)pos * (ROPE / 2);
    const float* sin_row = sin_t + (long long)pos * (ROPE / 2);
    for (int i = tid; i < HEADS * (LAT / 8); i += THREADS) {
        const int h = i / (LAT / 8), col = 8 * (i % (LAT / 8));
        uint4 v = make_uint4(0, 0, 0, 0);
        if (h0 + h < n_head)
            v = *reinterpret_cast<const uint4*>(q_lat + ((long long)b * n_head + h0 + h) * LAT + col);
        *reinterpret_cast<uint4*>(q_s + h * STRIDE + col) = v;
    }
    for (int i = tid; i < HEADS * (ROPE / 2); i += THREADS) {
        const int h = i / (ROPE / 2), j = i % (ROPE / 2);
        bf16* dst = q_s + h * STRIDE + LAT;
        if (h0 + h < n_head) {
            rotate(q_pe + b * q_pe_b + (h0 + h) * q_pe_h, cos_row, sin_row, j, dst);
        } else {
            dst[j] = dst[j + ROPE / 2] = __float2bfloat16(0.0f);
        }
    }
    for (int i = tid; i < LAT / 8; i += THREADS)
        *reinterpret_cast<uint4*>(new_s + 8 * i) =
            *reinterpret_cast<const uint4*>(c_kv + (long long)b * LAT + 8 * i);
    if (tid < ROPE / 2) rotate(k_pe + b * k_pe_b, cos_row, sin_row, tid, new_s + LAT);
    if (tid < HEADS) {
        m_s[tid] = M_INIT;
        l_s[tid] = 0.0f;
    }
    __syncthreads();
    const bool owner = k_begin <= pos && pos < k_end;
    if (owner && h0 == 0) {                          // one block writes the row
        bf16* row = cache + ((long long)b * s_len + pos) * ROW;
        for (int i = tid; i < ROW / 8; i += THREADS)
            *reinterpret_cast<uint4*>(row + 8 * i) = *reinterpret_cast<const uint4*>(new_s + 8 * i);
    }

    const float scale2 = scale * LOG2E;
    float o[8][4];                                        // warp's 64 columns: 8 n-tiles
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    const uint32_t q_addr = (uint32_t)__cvta_generic_to_shared(q_s);
    const uint32_t p_addr = (uint32_t)__cvta_generic_to_shared(p_s);

    for (int c = 0; c < chunks; ++c) {
        __syncthreads();                                  // stage (c + STAGES − 1) % STAGES is free
        issue(c + STAGES - 1);
        cp_async_wait<STAGES - 1>();
        __syncthreads();
        bf16* kc = ring + (c % STAGES) * CHUNK * STRIDE;
        const int r0 = k_begin + c * CHUNK;
        if (owner && r0 <= pos && pos < r0 + CHUNK) {
            for (int i = tid; i < ROW / 8; i += THREADS)
                *reinterpret_cast<uint4*>(kc + (pos - r0) * STRIDE + 8 * i) =
                    *reinterpret_cast<const uint4*>(new_s + 8 * i);
            __syncthreads();
        }
        const uint32_t k_addr = (uint32_t)__cvta_generic_to_shared(kc);

        // scores: warp w, rows 8w..8w+7 of the chunk, all 16 heads; two
        // chains of products (k steps 4i, 4i + 1 and 4i + 2, 4i + 3)
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 3
        for (int kk = 0; kk < ROW / 16; kk += 4) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int k0 = kk + 2 * half;
                uint32_t a0[4], a1[4], bk[4];
                ldmatrix_x4(a0, q_addr + 2 * ((lane % 16) * STRIDE + 16 * k0 + 8 * (lane / 16)));
                ldmatrix_x4(a1, q_addr + 2 * ((lane % 16) * STRIDE + 16 * (k0 + 1) + 8 * (lane / 16)));
                ldmatrix_x4(bk, k_addr + 2 * ((8 * warp + lane % 8) * STRIDE + 16 * k0 + 8 * (lane / 8)));
                float (&acc)[4] = half ? s2 : s;
                mma_bf16(acc, a0, bk[0], bk[1]);
                mma_bf16(acc, a1, bk[2], bk[3]);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += s2[e];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = 8 * warp + 2 * c4 + (e & 1);
            const int head = g + 8 * (e >> 1);
            s_s[head * SSTRIDE + key] = r0 + key < k_end ? s[e] * scale2 : -INFINITY;
        }
        __syncthreads();

        // the online softmax: 16 threads a head, 4 rows each
        {
            const int h = tid / 16, j = tid % 16;
            float v[4], mx = -INFINITY;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[e] = s_s[h * SSTRIDE + 4 * j + e];
                mx = fmaxf(mx, v[e]);
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_old = m_s[h];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.0f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bf16 pb = __float2bfloat16(exp2f(v[e] - m_new));
                p_s[h * PSTRIDE + 4 * j + e] = pb;
                sum += __bfloat162float(pb);
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

        // P (16 × 64) · V: warp w, columns 64w..64w+63
        const float a_lo = alpha_s[g], a_hi = alpha_s[g + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            o[j][0] *= a_lo;
            o[j][1] *= a_lo;
            o[j][2] *= a_hi;
            o[j][3] *= a_hi;
        }
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, p_addr + 2 * ((lane % 16) * PSTRIDE + 16 * kk + 8 * (lane / 16)));
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                uint32_t bv[4];
                const int key = 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
                const int col = 64 * warp + 16 * jj + 8 * (lane / 16);
                ldmatrix_x4_trans(bv, k_addr + 2 * (key * STRIDE + col));
                mma_bf16(o[2 * jj], a, bv[0], bv[1]);
                mma_bf16(o[2 * jj + 1], a, bv[2], bv[3]);
            }
        }
    }

    // the ranks meet: partial sums into shared memory (over the ring),
    // then rank r takes columns [r·512/ranks, (r+1)·512/ranks)
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem + RING_AT);     // [16][512]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int col = 64 * warp + 8 * j + 2 * c4;
        part[g * LAT + col] = o[j][0];
        part[g * LAT + col + 1] = o[j][1];
        part[(g + 8) * LAT + col] = o[j][2];
        part[(g + 8) * LAT + col + 1] = o[j][3];
    }
    cluster.sync();
    // each rank's share of a head: thread (head, rank), 8 lanes a head
    float* factor = s_s;                                  // [16][ranks]
    if (tid < HEADS * MAX_RANKS) {
        const int h = tid / MAX_RANKS, r = tid % MAX_RANKS;
        const bool ok = r < ranks;
        const float m = ok ? *cluster.map_shared_rank(m_s + h, r) : M_INIT;
        const float l = ok ? *cluster.map_shared_rank(l_s + h, r) : 0.0f;
        float mx = m;
#pragma unroll
        for (int off = 1; off < MAX_RANKS; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float f = exp2f(m - mx);
        float total = f * l;
#pragma unroll
        for (int off = 1; off < MAX_RANKS; off <<= 1)
            total += __shfl_xor_sync(0xffffffffu, total, off);
        if (ok) factor[h * ranks + r] = f / total;
    }
    __syncthreads();
    const int cols = LAT / ranks;
    for (int e = tid; e < HEADS * cols; e += THREADS) {
        const int h = e / cols, col = rank * cols + e % cols;
        if (h0 + h >= n_head) continue;
        float acc = 0.0f;
        for (int r = 0; r < ranks; ++r)
            acc += factor[h * ranks + r] * *cluster.map_shared_rank(part + h * LAT + col, r);
        out[((long long)b * n_head + h0 + h) * LAT + col] = __float2bfloat16(acc);
    }
    cluster.sync();      // no block leaves while another still reads its shared memory
}

// ranks a cluster: the visible rows' slices of about KEYS_PER_RANK, at
// most 8 (the portable cluster size), and no more than fill one wave
int plan_ranks(int s_len, int clusters) {
    int ranks = (s_len + KEYS_PER_RANK - 1) / KEYS_PER_RANK;
    const int wave = WAVE_BLOCKS / (clusters > 0 ? clusters : 1);
    ranks = ranks < wave ? ranks : wave;
    ranks = ranks < MAX_RANKS ? ranks : MAX_RANKS;
    int p2 = 1;                                           // a power of two: 512 / ranks columns
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
    const int head_tiles = (n_head + HEADS - 1) / HEADS;
    const int ranks = plan_ranks(s_len, batch * head_tiles);
    const cudaError_t err = launch_clusters(
        mla_attention_kernel, batch * head_tiles * ranks, THREADS, ranks, SMEM, 0,
        (cudaStream_t)stream, static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_pe),
        q_pe_b, q_pe_h, static_cast<const bf16*>(c_kv), static_cast<const bf16*>(k_pe), k_pe_b,
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<bf16*>(cache), static_cast<bf16*>(out), n_head, head_tiles, s_len,
        static_cast<const long long*>(pos_at), pos, scale);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The ranks tww_mla_attention launches a cluster with, for the Python
// mirror's check (ops/mla_ops.py:ranks).
extern "C" int tww_mla_attention_ranks(int s_len, int clusters) {
    return plan_ranks(s_len, clusters);
}

extern "C" const char* tww_mla_attention_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
