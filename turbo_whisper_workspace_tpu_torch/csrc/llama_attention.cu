// Llama GQA attention over the bf16 KV cache at a device position, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA inside its jitted
// layer scan (turbo_whisper_workspace_tpu/models/llama.py:156-168, the
// two einsums with the position mask and the f32 softmax). Per batch
// item b, query head i (kv head i // group) and query row r at position
// pos + r, over the cache rows (B, S, kvh·dh):
//   s_j = (q_r · K_j) · dh^-1/2        bf16 × bf16 products, f32 sums
//   s_j = -inf where j > pos + r       (keys past the row's position)
//   w   = softmax(s)                   f32
//   o_r = bf16(Σ_j bf16(w_j) · V_j)    f32 sums
// Masked keys contribute exact zeros in the JAX function, so reading
// only keys j ≤ pos + r changes nothing but the order of the sums. pos
// is an int64 in device memory (the LLM decode step a CUDA graph
// replays moves it there) or a host int (a prefill); the launch depends
// on the cache length S only, and each block sizes its loops from pos.
//
// What bounds it on the H100. A decode step (t = 1) reads, per layer,
// the pos + 1 written rows of K and V: 1024 bf16 values each at the 8B
// model's 8 kv heads of 128, 6.1 MB at 1500 positions, 1.8 µs at 3.35
// TB/s, and does ~2 operations a byte: bound by HBM, and in practice by
// the latency of one dependent chain (load, scores, softmax, P·V). A
// prefill of t = 1748 rows does 4·t²/2·dh·H ≈ 25 GFLOP a layer (causal
// half), 25 µs at 989 TFLOP/s: bound by the tensor cores.
//
// Design: two regimes, make_plan below (mirrored by ops/llama_ops.py:
// attention_plan, which tww_llama_attention_plan lets the card check).
//
// Decode (t ≤ 8 and group·t ≤ 32 query rows a kv head, padded to 4, 8
// or 32). One cluster of R ≤ 8 blocks per (b, kv head), R from S (about
// 64 keys a rank, so 8 from S = 512 on): the group·t rows of a kv head
// share every K and V byte, and 8 (b, kv head) pairs alone would fill 8
// of 132 SMs. R is capped at 264 / pairs (two blocks an SM): where the
// pairs alone fill the card, as the Whisper decoder's 160 do at a greedy
// step, more ranks only queue more clusters behind the first wave (4
// ranks there: 21 µs a call against 11 with one; PERF.md §6). The n =
// pos + t visible keys are cut in R equal slices read from pos on entry,
// so every rank has work (none is idle past pos but at the first few
// positions) and the launch is the same at every step. A
// rank streams its K rows, then its V rows, through one ring of 64-key
// tiles in 16-byte cp.async copies (4 stages, 64 KB in flight; rows
// padded by 16 bytes). Scores: 4 lanes a key and 8 keys a warp at once,
// dh/4 dims a lane against q in f32 in shared memory (padded so the 4
// lanes of a key read other banks), the rows' sums folded over the 4
// lanes by a reduce-scatter (one shuffle per row and level, halving the
// rows each level). The JAX rounding points are kept: each rank
// publishes its rows' (max, Σ exp) through distributed shared memory,
// every rank forms the global (M, L) in rank order and rounds
// w = bf16(exp(s − M) / L) before P·V, as the JAX einsum takes the bf16
// weights (the lesson of cluster_attention.cuh: the row's max and sum come
// before the weights). P·V: a thread a head dim, 256/dh key streams, f32
// sums, the streams folded in order through shared memory; the ranks'
// partials summed in rank order, each rank writing dh/R of the dims.
// A first design scored a key a warp (dh/4 lanes, 4 dims each, 8 rows
// padded): its per-key shuffle chains were the longest part of the
// block's time (PERF.md, PR 15).
//
// Prefill (everything else). Flash attention on mma.sync m16n8k16 bf16
// (f32 sums): a block of 4 warps takes 64 query rows of one head, Q in
// registers, K and V tiles of 64 keys double-buffered by cp.async into
// XOR-swizzled shared memory (conflict-free ldmatrix), online softmax in
// f32 with exp2 and the weights rounded to bf16 for the P·V product
// (P stays in registers). Tiles wholly past the diagonal are never
// loaded; the diagonal tile is masked by position. The online softmax
// rounds unnormalised weights, not the JAX ones; chip_smoke.py measures
// the deviation from the plain version. Blocks run the longest rows
// first (causal work grows with the row).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster_attention.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int TILE = 64;                 // keys a ring stage holds
constexpr int STAGES = 4;
constexpr int KEYS_PER_RANK = 64;        // the plan's slice before the ranks are capped
constexpr int WAVE_BLOCKS = 264;         // decode blocks in flight: two an SM of the H100's 132
constexpr int DECODE_MAX_T = 8;
constexpr int DECODE_MAX_ROWS = 32;
constexpr int PRE_THREADS = 128;
constexpr int PRE_ROWS = 64;             // query rows a prefill block (4 warps × 16)
constexpr int PRE_KEYS = 64;             // keys a prefill tile
constexpr size_t MAX_SMEM = 227 * 1024;

struct Plan {
    int decode, rows_max, ranks, slice;  // decode: rows_max (4, 8 or 32), R, keys a rank at most
};

// pairs: the (batch, kv head) pairs, a cluster each; where they alone
// fill the card (the Whisper decoder's 160 at a greedy step, 800 at a
// beam step), fewer ranks take longer slices
Plan make_plan(int t, int group, int s_len, int pairs) {
    if (t <= DECODE_MAX_T && group * t <= DECODE_MAX_ROWS) {
        int ranks = (s_len + KEYS_PER_RANK - 1) / KEYS_PER_RANK;
        ranks = ranks < 1 ? 1 : (ranks > MAX_RANKS ? MAX_RANKS : ranks);
        const int fill = WAVE_BLOCKS / (pairs < 1 ? 1 : pairs);
        ranks = ranks > fill ? (fill < 1 ? 1 : fill) : ranks;
        const int rows = group * t;
        return {1, rows <= 4 ? 4 : (rows <= 8 ? 8 : 32), ranks, (s_len + ranks - 1) / ranks};
    }
    return {0, 0, 0, 0};
}

__device__ __forceinline__ int read_pos(const long long* pos_at, int pos, int t, int s_len) {
    long long p = pos_at != nullptr ? *pos_at : (long long)pos;
    p = p < 0 ? 0 : p;                     // clamped: no value reads outside the cache
    return (int)(p > s_len - t ? s_len - t : p);
}

// 16 bytes, or 16 zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
}

// ---------------------------------------------------------------------------
// Decode regime

constexpr int KL = 4;                    // lanes that score a key together
constexpr int KPW = 32 / KL;             // keys a warp scores at once

// bf16 values a ring row holds: the head dim and 16 bytes of padding, so
// that the 8 keys a warp scores at once sit in other banks
template <int DH>
__host__ __device__ constexpr int ring_row() { return DH + 8; }

// floats of a lane's share of a q row in shared memory: DH/KL dims and 4
// of padding, so that the KL lanes of a key read other banks
template <int DH>
__host__ __device__ constexpr int q_part() { return DH / KL + 4; }

// the ring (K, then V tiles), which the P·V streams' partials reuse
template <int DH, int MR>
__host__ __device__ constexpr size_t region_bytes() {
    return (size_t)STAGES * TILE * ring_row<DH>() * 2 > (size_t)DEC_THREADS * MR * 4
               ? (size_t)STAGES * TILE * ring_row<DH>() * 2 : (size_t)DEC_THREADS * MR * 4;
}

template <int DH, int MR>
size_t decode_smem(int slice) {
    return region_bytes<DH, MR>() +
           sizeof(float) * ((size_t)slice * (MR + 4) + MR * DH + MR * KL * q_part<DH>());
}

// v[0..MR) summed over the KL lanes of a key group, scattered: returns
// the first row this lane holds; v[0..n) then hold rows base..base+n−1,
// n = max(1, MR/KL). With MR < KL several lanes hold the same row and
// only `writer` lanes should store it.
template <int MR>
__device__ __forceinline__ int reduce_rows(float (&v)[MR], int lane, bool& writer) {
    int base = 0;
    writer = true;
    int n = MR;
#pragma unroll
    for (int off = KL / 2; off >= 1; off /= 2) {
        if (n > 1) {
            n /= 2;
            const bool up = (lane & off) != 0;
#pragma unroll
            for (int i = 0; i < MR / 2; ++i) {
                if (i < n) {
                    const float send = up ? v[i] : v[i + n];
                    const float keep = up ? v[i + n] : v[i];
                    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
                }
            }
            base += up ? n : 0;
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
            writer = writer && (lane & off) == 0;
        }
    }
    return base;
}

template <int DH, int MR>
__global__ void __launch_bounds__(DEC_THREADS, 1)
decode_kernel(const bf16* __restrict__ q,      // (B, t, H, DH)
              const bf16* __restrict__ ck,     // (B, S, kvh·DH)
              const bf16* __restrict__ cv,
              bf16* __restrict__ o,            // (B, t, H·DH)
              int t, int n_head, int n_kv, int s_len, const long long* __restrict__ pos_at,
              int pos_host, int slice_max, float scale) {
    constexpr int ROW = ring_row<DH>();
    constexpr int QP = q_part<DH>();
    constexpr int DL = DH / KL;                       // dims a lane scores
    constexpr int MRS = MR + 4;                       // floats a key's row of scores
    constexpr int CHUNKS = TILE * DH / 8;             // 16-byte copies a tile
    constexpr int KP = DEC_THREADS / DH;              // P·V key streams
    constexpr int NR = MR / KL > 1 ? MR / KL : 1;     // score rows a lane stores
    static_assert(DH % 16 == 0 && DH <= 128 && DL % 4 == 0, "head dim");
    static_assert(TILE == DEC_WARPS * KPW, "a warp scores its keys of a tile at once");
    extern __shared__ __align__(16) uint8_t smem[];
    bf16* ring = reinterpret_cast<bf16*>(smem);                       // (STAGES, TILE, ROW)
    float* part = reinterpret_cast<float*>(smem);                     // (KP, MR, DH) at the end
    float* sc = reinterpret_cast<float*>(smem + region_bytes<DH, MR>());  // (slice, MRS)
    float* opart = sc + (size_t)slice_max * MRS;                      // (MR, DH)
    float* q_s = opart + MR * DH;                                     // (MR, KL, QP)
    __shared__ float pm[MR], pl[MR];

    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int bk = blockIdx.x / ranks;
    const int b = bk / n_kv;
    const int kh = bk % n_kv;
    const int group = n_head / n_kv;
    const int rows = group * t;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    // q's values in flight beside pos (row r is (ti, gi) = (r / group,
    // r % group), query head kh·group + gi)
    constexpr int QE = (MR * DH + DEC_THREADS - 1) / DEC_THREADS;
    float qv[QE];
#pragma unroll
    for (int u = 0; u < QE; ++u) {
        const int e = tid + u * DEC_THREADS;
        const int r = e / DH;
        qv[u] = e < MR * DH && r < rows
                    ? __bfloat162float(q[(((size_t)b * t + r / group) * n_head +
                                          (size_t)kh * group + r % group) * DH + e % DH])
                    : 0.0f;
    }
    const int p0 = read_pos(pos_at, pos_host, t, s_len);
    const int n_valid = p0 + t;
    const int slice = (n_valid + ranks - 1) / ranks;
    const int j0 = rank * slice;
    const int nk = max(0, min(slice, n_valid - j0));   // this rank's keys
    const int nt = (nk + TILE - 1) / TILE;
    const size_t width = (size_t)n_kv * DH;
    const bf16* kbase = ck + ((size_t)b * s_len + j0) * width + (size_t)kh * DH;
    const bf16* vbase = cv + ((size_t)b * s_len + j0) * width + (size_t)kh * DH;
    const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);

    // tile i of the 2·nt: K tiles first, then V tiles; one commit group each
    auto issue = [&](int i) {
        if (i < 2 * nt) {
            const bf16* base = i < nt ? kbase : vbase;
            const int tile = i < nt ? i : i - nt;
            const uint32_t dst = ring_addr + (uint32_t)((i % STAGES) * TILE * ROW * 2);
            for (int c = tid; c < CHUNKS; c += DEC_THREADS) {
                const int kk = c / (DH / 8);
                const int j = tile * TILE + kk;
                cp_async16_zfill(dst + (uint32_t)(kk * ROW * 2 + 16 * (c % (DH / 8))),
                                 base + (size_t)min(j, nk - 1) * width + 8 * (c % (DH / 8)),
                                 j < nk);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES; ++i) issue(i);

    // q as f32 in shared memory; lane l of a key group reads dims
    // [l·DL, (l+1)·DL)
#pragma unroll
    for (int u = 0; u < QE; ++u) {
        const int e = tid + u * DEC_THREADS;
        const int d = e % DH;
        if (e < MR * DH) q_s[((e / DH) * KL + d / DL) * QP + d % DL] = qv[u];
    }
    const int kg = lane / KL;
    const int kl = lane % KL;
    const float* qrow = q_s + kl * QP;

    // K tiles: the scores, scaled, −inf where the key is past the row's
    // position (or the row past group·t), at (key, row) in sc. Each warp
    // takes 8 keys of a tile, 4 lanes a key, DL dims a lane
    for (int i = 0; i < nt; ++i) {
        cp_async_wait<STAGES - 1>();
        __syncthreads();
        const int kk = warp * KPW + kg;
        const int j = i * TILE + kk;
        const bf16* krow = ring + (i % STAGES) * TILE * ROW + kk * ROW + kl * DL;
        float s[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r) s[r] = 0.0f;
#pragma unroll
        for (int u = 0; u < DL; u += 4) {
            const uint2 raw = *reinterpret_cast<const uint2*>(krow + u);
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                const float4 qv = *reinterpret_cast<const float4*>(qrow + r * KL * QP + u);
                s[r] = fmaf(qv.w, hi.y, fmaf(qv.z, hi.x, fmaf(qv.y, lo.y, fmaf(qv.x, lo.x, s[r]))));
            }
        }
        bool writer;
        const int base = reduce_rows<MR>(s, kl, writer);
        if (writer && j < nk) {
#pragma unroll
            for (int u = 0; u < NR; ++u) {
                const int r = base + u;
                const bool seen = r < rows && j0 + j <= p0 + r / group;
                sc[(size_t)j * MRS + r] = seen ? s[u] * scale : -INFINITY;
            }
        }
        __syncthreads();
        issue(i + STAGES);
    }

    // this rank's (max, Σ exp) of every row, published to the cluster
    // (−inf and 0 for a row with no key here)
    for (int r = warp; r < MR; r += DEC_WARPS) {
        float mx = -INFINITY;
        for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sc[(size_t)j * MRS + r]);
        mx = warp_max(mx);
        float sum = 0.0f;
        if (mx > -INFINITY)
            for (int j = lane; j < nk; j += 32) sum += expf(sc[(size_t)j * MRS + r] - mx);
        sum = warp_sum(sum);
        if (lane == 0) {
            pm[r] = mx;
            pl[r] = sum;
        }
    }
    cluster.sync();
    // the row's M and L = Σ_c l_c · exp(m_c − M) over the ranks in rank
    // order, then the weights bf16(exp(s − M) / L) in place of the scores
    // (0 for masked keys and padding rows)
    for (int r = warp; r < MR; r += DEC_WARPS) {
        float mc = -INFINITY, lc = 0.0f;
        if (lane < ranks) {
            mc = *cluster.map_shared_rank(pm + r, lane);
            lc = *cluster.map_shared_rank(pl + r, lane);
        }
        const float m = warp_max(mc);
        const float term = lc > 0.0f ? lc * expf(mc - m) : 0.0f;
        float l = 0.0f;
        for (int c = 0; c < ranks; ++c) l += __shfl_sync(0xffffffffu, term, c);
        for (int j = lane; j < nk; j += 32) {
            float* w = sc + (size_t)j * MRS + r;
            *w = r < rows && m > -INFINITY
                     ? __bfloat162float(__float2bfloat16(expf(*w - m) / l)) : 0.0f;
        }
    }
    __syncthreads();

    // V tiles: thread (stream kp, dim d) sums its keys' w · V for every row
    float acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0.0f;
    const int d = tid % DH;
    const int kp = tid / DH;
    for (int i = nt; i < 2 * nt; ++i) {
        cp_async_wait<STAGES - 1>();
        __syncthreads();
        const bf16* tile = ring + (i % STAGES) * TILE * ROW;
        const int j_base = (i - nt) * TILE;
#pragma unroll 4
        for (int kk = kp; kk < TILE; kk += KP) {
            const int j = j_base + kk;
            if (j < nk) {
                const float v = __bfloat162float(tile[kk * ROW + d]);
                const float* w = sc + (size_t)j * MRS;
#pragma unroll
                for (int r = 0; r < MR; r += 4) {
                    const float4 w4 = *reinterpret_cast<const float4*>(w + r);
                    acc[r] = fmaf(w4.x, v, acc[r]);
                    acc[r + 1] = fmaf(w4.y, v, acc[r + 1]);
                    acc[r + 2] = fmaf(w4.z, v, acc[r + 2]);
                    acc[r + 3] = fmaf(w4.w, v, acc[r + 3]);
                }
            }
        }
        __syncthreads();
        issue(i + STAGES);
    }
    cp_async_wait<0>();
    __syncthreads();
    // the streams' partials, folded in stream order into this rank's (MR, DH)
#pragma unroll
    for (int r = 0; r < MR; ++r) part[((size_t)kp * MR + r) * DH + d] = acc[r];
    __syncthreads();
    for (int e = tid; e < MR * DH; e += DEC_THREADS) {
        float sum = part[e];
        for (int c = 1; c < KP; ++c) sum += part[(size_t)c * MR * DH + e];
        opart[e] = sum;
    }
    cluster.sync();
    // this rank's dims of every row, summed over the ranks in rank order
    const int d0 = rank * DH / ranks;
    const int nd = (rank + 1) * DH / ranks - d0;
    for (int e = tid; e < rows * nd; e += DEC_THREADS) {
        const int r = e / nd;
        const int dd = d0 + e % nd;
        float v[MAX_RANKS];
#pragma unroll
        for (int c = 0; c < MAX_RANKS; ++c)
            v[c] = c < ranks ? *cluster.map_shared_rank(opart + r * DH + dd, c) : 0.0f;
        float sum = v[0];
#pragma unroll
        for (int c = 1; c < MAX_RANKS; ++c) sum += v[c];
        o[(((size_t)b * t + r / group) * n_head + (size_t)kh * group + r % group) * DH + dd] =
            __float2bfloat16(sum);
    }
    cluster.sync();      // no block leaves while another still reads its shared memory
}

// ---------------------------------------------------------------------------
// Prefill regime

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// byte offset of 16-byte chunk `ch` of row `r` in a tile of DH-wide rows,
// XOR-swizzled over 8 rows where a row holds 8 chunks or more
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
    constexpr int CH = DH / 8;
    return (uint32_t)((r * CH + (CH >= 8 ? (ch ^ (r & 7)) : ch)) * 16);
}

template <int DH>
constexpr size_t prefill_smem() {
    return (size_t)(PRE_ROWS + 4 * PRE_KEYS) * DH * 2;
}

template <int DH>
__global__ void __launch_bounds__(PRE_THREADS, 2)
prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ck,
               const bf16* __restrict__ cv, bf16* __restrict__ o, int t, int n_head,
               int n_kv, int s_len, const long long* __restrict__ pos_at, int pos_host,
               float scale_log2) {
    constexpr int CH = DH / 8;          // 16-byte chunks a row
    constexpr int KS = DH / 16;         // k-steps of Q·Kᵀ
    constexpr int NT = DH / 8;          // n-tiles of the output
    extern __shared__ __align__(128) uint8_t smem[];
    const uint32_t qs = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t ks0 = qs + PRE_ROWS * DH * 2;                 // (2, 64, DH)
    const uint32_t vs0 = ks0 + 2 * PRE_KEYS * DH * 2;            // (2, 64, DH)
    const int qt = gridDim.x - 1 - blockIdx.x;                   // the longest rows first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (n_head / n_kv);
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int g = lane / 4;
    const int c4 = lane % 4;
    const int p0 = read_pos(pos_at, pos_host, t, s_len);
    const int row0 = qt * PRE_ROWS;
    const int last = min(row0 + PRE_ROWS, t) - 1;
    const int key_end = p0 + last + 1;                  // keys [0, key_end) are seen
    const int n_kt = (key_end + PRE_KEYS - 1) / PRE_KEYS;
    const size_t width = (size_t)n_kv * DH;
    const bf16* kb = ck + (size_t)b * s_len * width + (size_t)kh * DH;
    const bf16* vb = cv + (size_t)b * s_len * width + (size_t)kh * DH;

    for (int c = tid; c < PRE_ROWS * CH; c += PRE_THREADS) {
        const int r = c / CH;
        const int row = row0 + r;
        const bool valid = row < t;
        cp_async16_zfill(qs + swz<DH>(r, c % CH),
                         q + (((size_t)b * t + (valid ? row : 0)) * n_head + h) * DH +
                             8 * (c % CH), valid);
    }
    auto load_kv = [&](int kt) {
        const uint32_t st = (uint32_t)((kt & 1) * PRE_KEYS * DH * 2);
        for (int c = tid; c < PRE_KEYS * CH; c += PRE_THREADS) {
            const int r = c / CH;
            const int key = kt * PRE_KEYS + r;
            const bool valid = key < key_end;
            const size_t off = (size_t)(valid ? key : 0) * width + 8 * (c % CH);
            cp_async16_zfill(ks0 + st + swz<DH>(r, c % CH), kb + off, valid);
            cp_async16_zfill(vs0 + st + swz<DH>(r, c % CH), vb + off, valid);
        }
        cp_async_commit();
    };
    load_kv(0);

    uint32_t qf[KS][4];
    float oacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    const int pos_a = p0 + row0 + warp * 16 + g;    // positions of this thread's two rows
    const int pos_b = pos_a + 8;

    for (int kt = 0; kt < n_kt; ++kt) {
        if (kt + 1 < n_kt) {
            load_kv(kt + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (kt == 0) {
#pragma unroll
            for (int s = 0; s < KS; ++s)
                ldmatrix_x4(qf[s], qs + swz<DH>(warp * 16 + (lane & 15), 2 * s + (lane >> 4)));
        }
        const uint32_t kst = ks0 + (kt & 1) * PRE_KEYS * DH * 2;
        const uint32_t vst = vs0 + (kt & 1) * PRE_KEYS * DH * 2;
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bf[4];
                ldmatrix_x4(bf, kst + swz<DH>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                              2 * ks + ((lane >> 3) & 1)));
                mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
                mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
            }
        }
        // scale, mask by position, online softmax (rows g and g + 8)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kt * PRE_KEYS + n * 8 + 2 * c4 + (e & 1);
                const float v = s[n][e] * scale_log2;
                s[n][e] = key <= (e < 2 ? pos_a : pos_b) ? v : -INFINITY;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
            }
        float alpha[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
            const float m_new = fmaxf(m[hf], mx[hf]);
            alpha[hf] = exp2f(m[hf] - m_new);
            m[hf] = m_new;
            l[hf] *= alpha[hf];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            oacc[n][0] *= alpha[0];
            oacc[n][1] *= alpha[0];
            oacc[n][2] *= alpha[1];
            oacc[n][3] *= alpha[1];
        }
        uint32_t pa[8][2];             // P in bf16, as the A operand's halves
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const __nv_bfloat162 p = __floats2bfloat162_rn(
                    exp2f(s[n][2 * hf] - m[hf]), exp2f(s[n][2 * hf + 1] - m[hf]));
                const float2 pf = __bfloat1622float2(p);
                l[hf] += pf.x + pf.y;
                pa[n][hf] = *reinterpret_cast<const uint32_t*>(&p);
            }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                                   pa[2 * kk + 1][1]};
#pragma unroll
            for (int dn = 0; dn < NT / 2; ++dn) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, vst + swz<DH>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                    2 * dn + (lane >> 4)));
                mma_bf16(oacc[2 * dn], a, bf[0], bf[1]);
                mma_bf16(oacc[2 * dn + 1], a, bf[2], bf[3]);
            }
        }
        __syncthreads();             // the stage is free for the tile after next
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    const int row_a = row0 + warp * 16 + g;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = row_a + 8 * hf;
        if (row < t) {
            const float inv = 1.0f / l[hf];
            bf16* out = o + (((size_t)b * t + row) * n_head + h) * DH + 2 * c4;
#pragma unroll
            for (int n = 0; n < NT; ++n)
                *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
                    oacc[n][2 * hf] * inv, oacc[n][2 * hf + 1] * inv);
        }
    }
}

// ---------------------------------------------------------------------------
// Launches. Each kernel's shared-memory limit is raised once to each
// larger size, so a launch captured into a CUDA graph after an eager one
// at the same shapes makes no attribute call.

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem, size_t& raised) {
    if (smem <= raised) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) raised = smem;
    return err;
}

template <int DH, int MR>
cudaError_t launch_decode(const Plan& p, const bf16* q, const bf16* ck, const bf16* cv,
                          bf16* o, int batch, int t, int n_head, int n_kv, int s_len,
                          const long long* pos_at, int pos, float scale,
                          cudaStream_t stream) {
    static size_t raised = 48 * 1024;
    const size_t smem = decode_smem<DH, MR>(p.slice);
    if (smem > MAX_SMEM - 2 * sizeof(float) * MR) return cudaErrorInvalidValue;
    cudaError_t err = raise_smem(decode_kernel<DH, MR>, smem, raised);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * n_kv * p.ranks);
    cfg.blockDim = dim3(DEC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, decode_kernel<DH, MR>, q, ck, cv, o, t, n_head, n_kv,
                              s_len, pos_at, pos, p.slice, scale);
}

template <int DH>
cudaError_t launch_prefill(const bf16* q, const bf16* ck, const bf16* cv, bf16* o, int batch,
                           int t, int n_head, int n_kv, int s_len, const long long* pos_at,
                           int pos, float scale, cudaStream_t stream) {
    static size_t raised = 48 * 1024;
    const cudaError_t err = raise_smem(prefill_kernel<DH>, prefill_smem<DH>(), raised);
    if (err != cudaSuccess) return err;
    const dim3 grid((t + PRE_ROWS - 1) / PRE_ROWS, n_head, batch);
    prefill_kernel<DH><<<grid, PRE_THREADS, prefill_smem<DH>(), stream>>>(
        q, ck, cv, o, t, n_head, n_kv, s_len, pos_at, pos, scale * 1.4426950408889634f);
    return cudaSuccess;
}

template <int DH>
cudaError_t dispatch(const bf16* q, const bf16* ck, const bf16* cv, bf16* o, int batch, int t,
                     int n_head, int n_kv, int s_len, const long long* pos_at, int pos,
                     float scale, cudaStream_t stream) {
    const Plan p = make_plan(t, n_head / n_kv, s_len, batch * n_kv);
    if (!p.decode)
        return launch_prefill<DH>(q, ck, cv, o, batch, t, n_head, n_kv, s_len, pos_at, pos,
                                  scale, stream);
    if (p.rows_max == 4)
        return launch_decode<DH, 4>(p, q, ck, cv, o, batch, t, n_head, n_kv, s_len, pos_at,
                                    pos, scale, stream);
    if (p.rows_max == 8)
        return launch_decode<DH, 8>(p, q, ck, cv, o, batch, t, n_head, n_kv, s_len, pos_at,
                                    pos, scale, stream);
    return launch_decode<DH, 32>(p, q, ck, cv, o, batch, t, n_head, n_kv, s_len, pos_at, pos,
                                 scale, stream);
}

}  // namespace

// q: (batch, t, n_head, head_dim) bf16, the rotated queries; ck, cv:
// (batch, s_len, n_kv·head_dim) bf16, one layer's cache, rows < pos + t
// written; o: (batch, t, n_head·head_dim) bf16. All contiguous and
// 16-byte aligned; head_dim 16, 32, 64 or 128; n_kv divides n_head;
// 1 ≤ t ≤ s_len. pos: an int64 in device memory at pos_at, or the host
// int `pos` when pos_at is null; clamped to [0, s_len − t]. scale:
// head_dim^-1/2 as the caller rounds it to f32. Returns
// cudaGetLastError() after the launch (or the launch's own error).
extern "C" int tww_llama_attention(const void* q, const void* ck, const void* cv, void* o,
                                   int batch, int t, int n_head, int n_kv, int head_dim,
                                   int s_len, const void* pos_at, int pos, float scale,
                                   void* stream) {
    if (batch < 1 || t < 1 || t > s_len || n_kv < 1 || n_head % n_kv || batch > 65535 ||
        n_head > 65535)
        return (int)cudaErrorInvalidValue;
    const bf16* qq = static_cast<const bf16*>(q);
    const bf16* kk = static_cast<const bf16*>(ck);
    const bf16* vv = static_cast<const bf16*>(cv);
    bf16* oo = static_cast<bf16*>(o);
    const long long* at = static_cast<const long long*>(pos_at);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    switch (head_dim) {
        case 16: err = dispatch<16>(qq, kk, vv, oo, batch, t, n_head, n_kv, s_len, at, pos, scale, st); break;
        case 32: err = dispatch<32>(qq, kk, vv, oo, batch, t, n_head, n_kv, s_len, at, pos, scale, st); break;
        case 64: err = dispatch<64>(qq, kk, vv, oo, batch, t, n_head, n_kv, s_len, at, pos, scale, st); break;
        case 128: err = dispatch<128>(qq, kk, vv, oo, batch, t, n_head, n_kv, s_len, at, pos, scale, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The plan tww_llama_attention launches for these arguments, for the
// Python mirror's check (ops/llama_ops.py:kernel_plan): out = {1, rows,
// ranks, slice} in the decode regime, {0, q_tiles, 0, 0} in the prefill.
extern "C" void tww_llama_attention_plan(int t, int group, int s_len, int pairs, int* out) {
    const Plan p = make_plan(t, group, s_len, pairs);
    out[0] = p.decode;
    out[1] = p.decode ? p.rows_max : (t + PRE_ROWS - 1) / PRE_ROWS;
    out[2] = p.ranks;
    out[3] = p.slice;
}

extern "C" const char* tww_llama_attention_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
