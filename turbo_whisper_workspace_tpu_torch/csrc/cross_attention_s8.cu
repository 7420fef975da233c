// Decoder cross-attention over int8 K/V with int8 queries and int8
// softmax weights (both products s8×s8 into s32) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// cross_attention_s8 (body _bd_attn_s8_kernel, pallas_call at :320), the
// opt-in twin of cross_attention_int8. Only the math is kept; the TPU's
// block-diagonal packing of all heads into one matrix product is a trick
// for its 128x128 matrix unit and has no place here. Per (b, h) and query
// row, with the TPU kernel's rounding points:
//   q'  = bf16(q · k_scale · d^-1/2 · log2 e)
//   qs  = max(max|q'|, 1e-30) / 127,  q8 = clip(rint(q' / qs), ±127)
//   s_t = f32(Σ_d q8 · K[d, t]) · qs          (t ≥ seq_len: masked)
//   p_t = exp2(s_t - max s),  w_t = p_t · (1 / Σ p)
//   ws  = max(max w, 1e-30) / 127,  w8 = rint(w / ws)   (no clip: w ≤ max w)
//   o_d = bf16((f32(Σ_t w8 · V[t, d]) · ws) · v_scale)
// Since max p = exp2(0) = 1 exactly, max w is 1 / Σ p itself.
//
// What bounds it on the H100: at a decode step (Tq = 1) it reads the
// whole int8 K and V of every (b, h) at t < seq_len, 2·B·H·64·seq_len
// bytes, and does about 2 integer operations per byte, so it is bound
// by HBM (3.35 TB/s): 30.7 MB, 9.2 µs at B = 8, H = 20, seq_len 1500.
// The bytes must all be in flight at once, across every SM, each read
// once.
//
// Design (cross_attention_int8's): one thread-block cluster of C blocks
// per (b·h), launched with cudaLaunchKernelEx; rank r owns keys
// [r·S, (r+1)·S). The plan is cross_attention_int8's (cross_plan in
// cluster_attention.cuh, ops/attention.py:cross_int8_plan); at Tpad
// 1536 it is C = 8, S = 192: 1280 blocks of 128 threads at B = 8, H = 20.
//   Loads: each block reads its first query rows, then issues its whole
// slice with 16-byte cp.async before any compute: K (64 rows × S bytes,
// 16-key chunks up to seq_len) as one commit group, V (S rows × 64
// bytes, rows < seq_len) as a second. It quantizes the query while the
// copies travel, waits for K, scores, and waits for V only before P·V.
// Shared memory is what limits the blocks resident on an SM (30.7 MB of
// K/V do not fit the card's 132 × 227 KB at once, so the blocks run in
// more than one wave): nothing but the slice, the scores and the weights
// is kept per row. V rows are unpadded; the two key streams of a warp
// read a quad's rows in rotated orders so that P·V's reads are still
// free of bank conflicts; the per-warp s32 partials meet by shared
// atomics (exact in any order) in one (rows × 64) array.
//   Products: dp4a, 4 products a instruction, at every Tq. K and V hold
// the 4 bytes a dp4a pairs one row apart, so a thread reads a 4x4 byte
// block (one 32-bit load a row, neighbouring lanes on neighbouring
// words) and transposes it with byte permutes (int8_blocks.cuh). At
// Tq > 1 each transposed block serves every query row of the chunk
// (ROWS × 4 dp4a per 4 loads); mma.sync m16n8k32 would pad Tq ≤ 8 rows
// to 16 and needs the same transposes, so it is not used.
//   Softmax across the cluster, at the TPU kernel's rounding point: the
// weights are quantized after normalisation, so every rank needs the
// global max and sum first. Each rank keeps its f32 scores in shared
// memory and publishes (m_r, Σ exp2(s − m_r)) per row; after one cluster
// barrier every rank reads all C pairs at once (one lane per rank,
// through distributed shared memory), forms M and
// Σ = Σ_r sum_r · exp2(m_r − M) in rank order (the same Σ on every rank)
// and recomputes w8 = rint(fmul_rn(exp2(s − M), 1/Σ) / ws) from its
// stored scores against the global M: a local exp2(s − m_r) is never
// rescaled, which would move the rounding point. Only Σ's f32 order
// differs from the plain version.
//   P·V: each rank's exact s32 partial of w8 · V (rows × 64) goes to
// shared memory; after a second barrier rank r sums output dims
// [64r/C, 64(r+1)/C) over the C ranks (integer sums: exact in any order)
// and writes bf16(f32(sum) · ws · v_scale). Query rows go in even chunks
// of at most 8 (one kernel instance per chunk size); the slice stays in
// shared memory for every chunk, so K/V are read from HBM once whatever
// Tq is.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster_attention.cuh"
#include "int8_blocks.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;                 // head dim
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PV_STREAMS = THREADS / 16;   // key-quad streams in P·V
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

static_assert(CROSS_MAX_ROWS == 2 * WARPS, "warp w quantizes rows w and w + WARPS");

// the dynamic shared memory of one block (layout in the kernel)
__host__ __device__ constexpr size_t smem_bytes(int rows, int slice) {
    return 2 * (size_t)D * slice +
           (size_t)rows * slice * (sizeof(float) + 1) + sizeof(int) * (size_t)rows * D +
           sizeof(float) * 4 * (size_t)rows + (size_t)rows * D;
}

__device__ __forceinline__ int quantize_q(float v, float qs) {
    return (int)fminf(fmaxf(rintf(v / qs), -127.0f), 127.0f);
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS)
cross_attention_s8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H, Tq, 64)
                          const int8_t* __restrict__ kq,        // (B, H, 64, Tpad)
                          const int8_t* __restrict__ vq,        // (B, Tpad, H·64)
                          const float* __restrict__ k_scale,    // (B, H)
                          const float* __restrict__ v_scale,    // (B, H)
                          __nv_bfloat16* __restrict__ o,        // (B, H, Tq, 64)
                          int n_head, int tq, int tpad, int seq_len, int slice) {
    extern __shared__ __align__(16) uint8_t smem[];
    int8_t* k_s = reinterpret_cast<int8_t*>(smem);                  // (64, S)
    int8_t* v_s = k_s + D * slice;                                    // (S, 64)
    float* sc = reinterpret_cast<float*>(v_s + slice * D);            // (ROWS, S) scores
    int* opart = reinterpret_cast<int*>(sc + ROWS * slice);           // (ROWS, 64)
    float* pmax = reinterpret_cast<float*>(opart + ROWS * D);         // (ROWS)
    float* psum = pmax + ROWS;                                        // (ROWS)
    float* qsc = psum + ROWS;                                         // (ROWS) query scales
    float* wsc = qsc + ROWS;                                          // (ROWS) weight scales
    unsigned* q8 = reinterpret_cast<unsigned*>(wsc + ROWS);           // (ROWS, 16) 4 dims a word
    int8_t* w8 = reinterpret_cast<int8_t*>(q8 + ROWS * D / 4);        // (ROWS, S) weights

    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int bh = blockIdx.x / ranks;
    const int b = bh / n_head;
    const int h = bh % n_head;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int k0 = rank * slice;
    const int nv = max(0, min(slice, seq_len - k0));   // this rank's keys < seq_len
    const int nquads = (nv + 3) / 4;

    // warp w's query rows w and w + WARPS of a chunk (dims lane, lane + 32),
    // read ahead of the slice's copies so that they do not queue behind them
    float q_next[2][2];
    auto load_q = [&](int r0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = r0 + warp + i * WARPS;
            const bool in = warp + i * WARPS < ROWS && r < tq;
            const __nv_bfloat16* qrow = q + ((size_t)bh * tq + r) * D;
            q_next[i][0] = in ? __bfloat162float(qrow[lane]) : 0.0f;
            q_next[i][1] = in ? __bfloat162float(qrow[lane + 32]) : 0.0f;
        }
    };
    load_q(0);
    const float qk = k_scale[bh] * SCALE_LOG2;

    // every load of the slice, before any compute: K, then V
    {
        const int chunks = (nv + 15) / 16;
        const int8_t* kh = kq + (size_t)bh * D * tpad + k0;
        const uint32_t ks_addr = (uint32_t)__cvta_generic_to_shared(k_s);
        for (int i = tid; i < D * chunks; i += THREADS) {
            const int d = i / chunks;
            const int c = i % chunks;
            cp_async16(ks_addr + d * slice + 16 * c, kh + (size_t)d * tpad + 16 * c);
        }
        cp_async_commit();
        const size_t vstride = (size_t)n_head * D;
        const int8_t* vh = vq + ((size_t)b * tpad + k0) * vstride + (size_t)h * D;
        const uint32_t vs_addr = (uint32_t)__cvta_generic_to_shared(v_s);
        for (int i = tid; i < nv * 4; i += THREADS) {
            const int j = i / 4;
            const int c = i % 4;
            cp_async16(vs_addr + j * D + 16 * c, vh + (size_t)j * vstride + 16 * c);
        }
        cp_async_commit();
    }

    const float vscale = v_scale[bh];
    const int d0 = rank * D / ranks;
    const int d1 = (rank + 1) * D / ranks;

    for (int r0 = 0; r0 < tq; r0 += ROWS) {
        const int nr = min(ROWS, tq - r0);
        if (r0 > 0) load_q(r0);
        // q' = bf16(q · k_scale · d^-1/2 · log2 e), quantized per row;
        // rows past the chunk are zeros
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = warp + i * WARPS;
            if (r < ROWS) {
                const float v0 = __bfloat162float(__float2bfloat16(q_next[i][0] * qk));
                const float v1 = __bfloat162float(__float2bfloat16(q_next[i][1] * qk));
                const float qs = fmaxf(warp_max(fmaxf(fabsf(v0), fabsf(v1))), 1e-30f) / 127.0f;
                int8_t* row8 = reinterpret_cast<int8_t*>(q8 + r * (D / 4));
                row8[lane] = (int8_t)quantize_q(v0, qs);
                row8[lane + 32] = (int8_t)quantize_q(v1, qs);
                if (lane == 0) qsc[r] = qs;
            }
        }
        if (r0 == 0) cp_async_wait<1>();          // this thread's K copies landed
        __syncthreads();

        // scores: thread g owns key quad g (keys 4g..4g+3 of the slice),
        // a 4x4 block of K rows d..d+3 per dp4a step
        for (int g = tid; g < nquads; g += THREADS) {
            int acc[ROWS][4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = 0;
#pragma unroll 4
            for (int db = 0; db < D / 4; ++db) {
                unsigned rows4[4], cols4[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    rows4[i] = *reinterpret_cast<const unsigned*>(k_s + (4 * db + i) * slice + 4 * g);
                transpose4x4(rows4, cols4);           // cols4[j] = K[4db..4db+3, 4g + j]
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const int qw = (int)q8[r * (D / 4) + db];
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a((int)cols4[j], qw, acc[r][j]);
                }
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (r < nr && 4 * g + j < nv)
                        sc[r * slice + 4 * g + j] = __fmul_rn((float)acc[r][j], qsc[r]);
        }
        __syncthreads();

        // this rank's max m_r and Σ exp2(s − m_r) per row, published for
        // the cluster (−inf and 0 for a rank past seq_len)
        for (int r = warp; r < nr; r += WARPS) {
            float mx = -INFINITY;
            for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, sc[r * slice + t]);
            mx = warp_max(mx);
            float sum = 0.0f;
            for (int t = lane; t < nv; t += 32) sum += exp2f(sc[r * slice + t] - mx);
            sum = warp_sum(sum);
            if (lane == 0) {
                pmax[r] = mx;
                psum[r] = sum;
            }
        }
        cluster.sync();
        // the global max M (rank 0 always holds a key: seq_len ≥ 1) and
        // Σ = Σ_r sum_r · exp2(m_r − M) in rank order, the same on every
        // rank; then the weights, recomputed from the scores against M and
        // quantized at ws = max w / 127 = (1/Σ) / 127
        for (int r = warp; r < nr; r += WARPS) {
            // lane c < C reads rank c's pair (the remote reads in parallel)
            float mc = -INFINITY, sc_c = 0.0f;
            if (lane < ranks) {
                mc = *cluster.map_shared_rank(pmax + r, lane);
                sc_c = *cluster.map_shared_rank(psum + r, lane);
            }
            const float m = warp_max(mc);
            const float term = sc_c * exp2f(mc - m);
            float sum = 0.0f;
            for (int c = 0; c < ranks; ++c) sum += __shfl_sync(0xffffffffu, term, c);
            const float inv = 1.0f / sum;
            const float ws = fmaxf(inv, 1e-30f) / 127.0f;
            // keys nv..4·nquads − 1 of the last quad weigh 0 in P·V
            for (int t = lane; t < 4 * nquads; t += 32)
                w8[r * slice + t] =
                    t < nv ? (int8_t)(int)rintf(__fmul_rn(exp2f(sc[r * slice + t] - m), inv) / ws)
                           : (int8_t)0;
            if (lane == 0) wsc[r] = ws;
        }
        // the P·V sums start from zero (every rank has read this rank's
        // last chunk: it passed the barrier above)
        for (int i = tid; i < ROWS * D; i += THREADS) opart[i] = 0;
        if (r0 == 0) cp_async_wait<0>();          // this thread's V copies landed
        __syncthreads();

        // P·V over the slice: thread (key-quad stream kg, dims 4·dq..4·dq+3);
        // the odd streams read a quad's rows from its second on (rows 4
        // apart would share banks) and rotate the weights' word alike
        {
            const int dq = tid % 16;
            const int kg = tid / 16;
            const int rot = kg & 1;
            int acc[ROWS][4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = 0;
            for (int g = kg; g < nquads; g += PV_STREAMS) {
                unsigned rows4[4], cols4[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    rows4[i] = *reinterpret_cast<const unsigned*>(
                        v_s + (4 * g + ((i + rot) & 3)) * D + 4 * dq);
                transpose4x4(rows4, cols4);           // cols4[j] byte i = V[4g + (i+rot)%4, 4·dq + j]
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    if (r < nr) {
                        const unsigned w4 = *reinterpret_cast<const unsigned*>(w8 + r * slice + 4 * g);
                        const int ww = (int)__funnelshift_r(w4, w4, 8 * rot);
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a((int)cols4[j], ww, acc[r][j]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
            if (lane < 16) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (r < nr) atomicAdd(opart + r * D + 4 * dq + j, acc[r][j]);
            }
        }
        cluster.sync();
        // this rank's output dims, summed over the ranks (exact)
        const int nd = d1 - d0;
        for (int i = tid; i < nr * nd; i += THREADS) {
            const int r = i / nd;
            const int d = d0 + i % nd;
            int v[MAX_RANKS];
#pragma unroll
            for (int c = 0; c < MAX_RANKS; ++c)   // the remote reads in parallel
                v[c] = c < ranks ? *cluster.map_shared_rank(opart + r * D + d, c) : 0;
            int sum = 0;
#pragma unroll
            for (int c = 0; c < MAX_RANKS; ++c) sum += v[c];
            const float full = __fmul_rn((float)sum, wsc[r]);
            o[((size_t)bh * tq + r0 + r) * D + d] = __float2bfloat16(__fmul_rn(full, vscale));
        }
    }
    cp_async_wait<0>();
    cluster.sync();      // no block leaves while another still reads its shared memory
}

template <int ROWS>
cudaError_t launch(const CrossPlan& p, const void* q, const void* kq, const void* vq,
                   const void* k_scale, const void* v_scale, void* o, int batch,
                   int n_head, int tq, int tpad, int seq_len, cudaStream_t stream) {
    return launch_clusters(cross_attention_s8_kernel<ROWS>, batch * n_head * p.ranks, THREADS,
                           p.ranks, smem_bytes(ROWS, p.slice), 0, stream,
                           static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
                           static_cast<const int8_t*>(vq), static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(o),
                           n_head, tq, tpad, seq_len, p.slice);
}

}  // namespace

// q, o: (batch, n_head, tq, 64) bf16; kq: (batch, n_head, 64, tpad) int8;
// vq: (batch, tpad, n_head·64) int8; k_scale, v_scale: (batch, n_head)
// f32. All contiguous, kq and vq 16-byte aligned; tpad a multiple of 16
// and at most 8192; 1 ≤ seq_len ≤ tpad. Returns cudaGetLastError() after
// the launch (or the launch's own error).
extern "C" int tww_cross_attention_s8(const void* q, const void* kq, const void* vq,
                                      const void* k_scale, const void* v_scale, void* o,
                                      int batch, int n_head, int tq, int tpad, int seq_len,
                                      void* stream) {
    if (tpad % 16 || tpad > MAX_RANKS * CROSS_MAX_SLICE || seq_len < 1 || seq_len > tpad ||
        tq < 1)
        return (int)cudaErrorInvalidValue;
    const CrossPlan p = cross_plan(tq, tpad);
    const cudaStream_t s = (cudaStream_t)stream;
    using Launch = cudaError_t (*)(const CrossPlan&, const void*, const void*, const void*,
                                   const void*, const void*, void*, int, int, int, int, int,
                                   cudaStream_t);
    static const Launch by_rows[CROSS_MAX_ROWS] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                                   launch<5>, launch<6>, launch<7>, launch<8>};
    const cudaError_t err = by_rows[p.rows - 1](p, q, kq, vq, k_scale, v_scale, o, batch,
                                                n_head, tq, tpad, seq_len, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* tww_cross_attention_s8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
