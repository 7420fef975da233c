// Decoder cross-attention over int8 K/V for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// cross_attention_int8 (body _bd_attn_int8_kernel, pallas_call at :226).
// Only the math is kept; the TPU's block-diagonal packing of all heads
// into one matrix product (_bd_expand/_bd_extract) is a trick for its
// 128x128 matrix unit and has no place here. Per (b, h):
//   q' = bf16(q · k_scale · d^-1/2 · log2 e)
//   s  = q' · K[:, t]            (f32 sums; t ≥ seq_len masked)
//   w  = bf16(exp2(s - max) · (1/Σ))
//   o  = bf16((w · V) · v_scale)  (f32 sums, one rounding at the end)
//
// What bounds it on the H100: at a decode step (Tq = 1) it reads the
// int8 K and V of every (b, h) once, 2·B·H·64·seq_len bytes, and does
// about 2 operations per byte, so it is bound by HBM (3.35 TB/s): at
// B = 8, H = 20, seq_len 1500 that is 30.7 MB, 9.2 µs. The bytes must all
// be in flight at once, across every SM, and each read once.
//
// Design: one thread-block cluster of C blocks per (b·h), launched with
// cudaLaunchKernelEx; rank r owns keys [r·S, (r+1)·S). The plan (C ≤ 8,
// S a multiple of 16, the query chunk) is cross_plan in
// cluster_attention.cuh, mirrored by ops/attention.py:cross_int8_plan
// and shared with cross_attention_s8.cu; at Tpad 1536 it is C = 8, S = 192:
// 1280 blocks of 128 threads for B = 8, H = 20.
//   Loads: before any compute each block reads its first query rows (so
// that they do not queue behind the slice) and issues its slice's 16-byte
// cp.async copies, K (64 rows × S contiguous bytes, 16-key chunks up to
// seq_len) as one commit group and V (S keys × 64 contiguous bytes at a
// row stride of H·64, keys < seq_len) as a second; it waits for K, scores,
// and waits for V only before P·V, so V's bytes travel while the scores
// and the softmax run. The slice stays in shared memory for every query
// chunk, so K/V are read from HBM once whatever Tq is.
//   Softmax across the cluster, at the TPU kernel's rounding point: the
// weights are rounded to bf16 after normalisation, so every rank needs
// the global max and sum first. Each rank publishes its per-row partial
// max m_r and partial sum Σ exp2(s − m_r) in shared memory; after one
// cluster barrier every rank reads all C pairs through distributed
// shared memory (map_shared_rank), forms the global M and
// Σ = Σ_r sum_r · exp2(m_r − M) in rank order (every rank gets the same
// Σ) and rounds w = bf16(exp2(s − M) · (1/Σ)). One exchange, not a max
// exchange and then a sum exchange: a cluster barrier costs
// microseconds, and only Σ's f32 rounding differs. No split-K combine
// kernel: that would round the weights before Σ is known, or rescale
// after.
//   P·V: each rank's f32 partial (rows × 64) goes to shared memory; after
// a second barrier rank r sums output dims [64r/C, 64(r+1)/C) over the C
// ranks in rank order and writes bf16(sum · v_scale).
//   Bytes become floats through a byte permute into the exponent field
// of 2^23 and one subtraction (bytes_to_float). Query rows go in even
// chunks of at most 8 (one kernel
// instance per chunk size), so no chunk computes absent rows but the last.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;                 // head dim
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int QT_W = 8;               // q' columns kept per head dim
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

// bytes between K rows in shared memory: the slice, padded so that the
// row stride in words is 8 (mod 16)
__host__ __device__ __forceinline__ int k_row_bytes(int slice) {
    return slice + 4 * ((24 - (slice / 4) % 16) % 16);
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS)
cross_attention_int8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H, Tq, 64)
                            const int8_t* __restrict__ kq,        // (B, H, 64, Tpad)
                            const int8_t* __restrict__ vq,        // (B, Tpad, H·64)
                            const float* __restrict__ k_scale,    // (B, H)
                            const float* __restrict__ v_scale,    // (B, H)
                            __nv_bfloat16* __restrict__ o,        // (B, H, Tq, 64)
                            int n_head, int tq, int tpad, int seq_len, int slice) {
    extern __shared__ __align__(16) uint8_t smem[];
    int8_t* k_s = reinterpret_cast<int8_t*>(smem);                  // (64, S), rows ks_ld apart
    const int ks_ld = k_row_bytes(slice);
    int8_t* v_s = k_s + D * ks_ld;                                    // (S, 64)
    float* sc = reinterpret_cast<float*>(v_s + slice * D);            // (ROWS, S)
    float* q_t = sc + ROWS * slice;                                   // (64, QT_W)
    float* pmax = q_t + D * QT_W;                                     // (ROWS)
    float* psum = pmax + ROWS;                                        // (ROWS)
    float* opart = psum + ROWS;                                       // (ROWS, 64)
    float* part = opart + ROWS * D;                                   // (WARPS, ROWS, 64)

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

    // the first query chunk's q, read ahead of the slice's copies so that
    // it does not queue behind them
    constexpr int QN = D * QT_W / THREADS;       // q' entries a thread writes
    auto load_q = [&](int r0, float (&v)[QN]) {
#pragma unroll
        for (int u = 0; u < QN; ++u) {
            const int i = tid + THREADS * u;
            const int r = i % QT_W;
            v[u] = r0 + r < tq ? __bfloat162float(q[((size_t)bh * tq + r0 + r) * D + i / QT_W])
                               : 0.0f;
        }
    };
    float q_next[QN];
    load_q(0, q_next);
    const float qscale = k_scale[bh] * SCALE_LOG2;

    // every load of the slice, before any compute: K, then V
    {
        const int chunks = (nv + 15) / 16;
        const int8_t* kh = kq + (size_t)bh * D * tpad + k0;
        const uint32_t ks_addr = (uint32_t)__cvta_generic_to_shared(k_s);
        for (int i = tid; i < D * chunks; i += THREADS) {
            const int d = i / chunks;
            const int c = i % chunks;
            cp_async16(ks_addr + d * ks_ld + 16 * c, kh + (size_t)d * tpad + 16 * c);
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
    const int nquads = (nv + 3) / 4;
    const int d0 = rank * D / ranks;
    const int d1 = (rank + 1) * D / ranks;

    for (int r0 = 0; r0 < tq; r0 += ROWS) {
        const int nr = min(ROWS, tq - r0);
        // q' = bf16(q · k_scale · d^-1/2 · log2 e), stored (d, row); rows
        // past this chunk's are zero
        if (r0 > 0) load_q(r0, q_next);
#pragma unroll
        for (int u = 0; u < QN; ++u) {
            const int i = tid + THREADS * u;
            q_t[i] = i % QT_W < nr ? __bfloat162float(__float2bfloat16(q_next[u] * qscale))
                                   : 0.0f;
        }
        if (r0 == 0) cp_async_wait<1>();          // this thread's K copies landed
        __syncthreads();

        // scores: 4 lanes per key quad g, lane dq summing head dims
        // d ≡ dq (mod 4); the quad's 4 partial sums meet by two shuffles.
        // K rows are ks_ld bytes apart, ks_ld/4 ≡ 8 (mod 16) words, so the
        // 32 lanes' reads hit 32 banks
        {
            const int dq = lane % 4;
            for (int it0 = warp * 32; it0 < 4 * nquads; it0 += THREADS) {
                const int g = min((it0 + lane) / 4, nquads - 1);
                float s[ROWS][4];
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;
#pragma unroll
                for (int i = 0; i < D / 4; ++i) {
                    const int d = 4 * i + dq;
                    float k4[4];
                    bytes_to_float(*reinterpret_cast<const uint32_t*>(k_s + d * ks_ld + 4 * g), k4);
                    const float* qd = q_t + d * QT_W;
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        const float qv = qd[r];
#pragma unroll
                        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv, k4[j], s[r][j]);
                    }
                }
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], 1);
                        s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], 2);
                    }
                // lane dq writes key 4g + dq of every row
                if (it0 + lane < 4 * nquads && 4 * g + dq < nv) {
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        float v = s[r][0];
#pragma unroll
                        for (int j = 1; j < 4; ++j) v = dq == j ? s[r][j] : v;
                        if (r < nr) sc[r * slice + 4 * g + dq] = v;
                    }
                }
            }
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
        // rank; then w = bf16(exp2(s − M) · (1/Σ))
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
            for (int t = lane; t < nv; t += 32)
                sc[r * slice + t] =
                    __bfloat162float(__float2bfloat16(exp2f(sc[r * slice + t] - m) * inv));
        }
        if (r0 == 0) cp_async_wait<0>();          // this thread's V copies landed
        __syncthreads();

        // P·V over the slice: thread (key stream kg, dims 4·dq..4·dq+3)
        {
            const int dq = tid % 16;
            const int kg = tid / 16;
            float acc[ROWS][4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
            for (int t = kg; t < nv; t += THREADS / 16) {
                float v4[4];
                bytes_to_float(*reinterpret_cast<const uint32_t*>(v_s + t * D + 4 * dq), v4);
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float w = sc[r * slice + t];
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(w, v4[j], acc[r][j]);
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
                    for (int j = 0; j < 4; ++j) part[(warp * ROWS + r) * D + 4 * dq + j] = acc[r][j];
            }
        }
        __syncthreads();
        for (int i = tid; i < nr * D; i += THREADS) {
            float sum = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) sum += part[w * ROWS * D + i];
            opart[i] = sum;
        }
        cluster.sync();
        // this rank's output dims, summed over the ranks in rank order
        const int nd = d1 - d0;
        for (int i = tid; i < nr * nd; i += THREADS) {
            const int r = i / nd;
            const int d = d0 + i % nd;
            float v[MAX_RANKS];
#pragma unroll
            for (int c = 0; c < MAX_RANKS; ++c)   // the remote reads in parallel
                v[c] = c < ranks ? *cluster.map_shared_rank(opart + r * D + d, c) : 0.0f;
            float sum = v[0];
#pragma unroll
            for (int c = 1; c < MAX_RANKS; ++c) sum += v[c];
            o[((size_t)bh * tq + r0 + r) * D + d] = __float2bfloat16(sum * vscale);
        }
    }
    cp_async_wait<0>();
    cluster.sync();      // no block leaves while another still reads its shared memory
}

template <int ROWS>
cudaError_t launch(const CrossPlan& p, const void* q, const void* kq, const void* vq,
                   const void* k_scale, const void* v_scale, void* o, int batch,
                   int n_head, int tq, int tpad, int seq_len, cudaStream_t stream) {
    const size_t smem = (size_t)D * (k_row_bytes(p.slice) + p.slice) +
                        sizeof(float) * ((size_t)ROWS * p.slice + D * QT_W + 2 * ROWS +
                                         (size_t)(1 + WARPS) * ROWS * D);
    return launch_clusters(cross_attention_int8_kernel<ROWS>, batch * n_head * p.ranks,
                           THREADS, p.ranks, smem, 0, stream,
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
extern "C" int tww_cross_attention_int8(const void* q, const void* kq, const void* vq,
                                        const void* k_scale, const void* v_scale,
                                        void* o, int batch, int n_head, int tq,
                                        int tpad, int seq_len, void* stream) {
    if (tpad % 16 || tpad > MAX_RANKS * CROSS_MAX_SLICE || seq_len < 1 || seq_len > tpad ||
        tq < 1)
        return (int)cudaErrorInvalidValue;
    const CrossPlan p = cross_plan(tq, tpad);
    const cudaStream_t s = (cudaStream_t)stream;
    using Launch = cudaError_t (*)(const CrossPlan&, const void*, const void*, const void*,
                                   const void*, const void*, void*, int, int, int, int, int,
                                   cudaStream_t);
    static const Launch by_rows[8] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                      launch<5>, launch<6>, launch<7>, launch<8>};
    const cudaError_t err = by_rows[p.rows - 1](p, q, kq, vq, k_scale, v_scale, o, batch,
                                                n_head, tq, tpad, seq_len, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* tww_cross_attention_int8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
