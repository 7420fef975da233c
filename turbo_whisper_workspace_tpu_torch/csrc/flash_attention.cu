// Encoder self-attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/attention.py:
// flash_attention (body _one_pass_kernel, pallas_call at :81): non-causal
// softmax(Q Kᵀ / √d) V over (B, H, T, 64) bf16, softmax in f32 with
// log2(e) folded into the scale and exp2.
//
// What bounds it on the H100: at the encoder's shape (T = 1500, d = 64)
// it does 4·B·H·T²·d operations on 4·B·H·T·d·2 bytes of q/k/v/o, about
// 750 operations per byte, well above the ~295 at which the bf16 tensor
// cores (989 TFLOP/s) rather than HBM (3.35 TB/s) become the limit. So
// it is compute-bound, and the (T, T) score matrix must never reach HBM.
//
// Design: one block of 4 warps per (b·h, 64-row Q tile). The Q tile is
// loaded once into tensor-core fragments; the loop walks 64-key K/V
// tiles through shared memory with an online softmax (running max and
// sum in f32 per row, exp2), so scores live only in shared memory. Both
// products are bf16 `nvcuda::wmma` 16x16x16 tiles with f32 sums; each
// warp owns 16 query rows, and two threads own each row's statistics
// and output accumulator (32 columns each, in registers). Keys t ≥ T
// are masked inside the kernel, so the wrapper passes the unpadded
// tensors. The output is normalised once at the end and written bf16.
// q, k, v and o are addressed through (batch, head, row) strides, so
// the encoder passes its (B, T, H·64) projections as they are: a head is
// a 64-column slice of each row, and no transposed copy is made.
// Not yet used: wgmma, TMA, a multi-stage ring of tiles (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int D = 64;               // head dim
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per K/V tile
constexpr int WARPS = BQ / 16;      // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDH = D + 8;          // bf16 row stride in shared memory
constexpr int LDS = BK + 4;         // f32 row stride in shared memory
// d^-1/2 · log2(e): softmax through exp2
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

static_assert(D == BK, "the score buffer also holds the 16x64 PV tile");
static_assert(THREADS == 2 * BQ, "two threads per query row");

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int n_head, int t_len,
                       long long stride_b, long long stride_h, long long stride_t) {
    // Q tile; once its fragments are in registers, the same rows hold P
    __shared__ __align__(32) __nv_bfloat16 qp_s[BQ * LDH];
    __shared__ __align__(32) __nv_bfloat16 k_s[BK * LDH];
    __shared__ __align__(32) __nv_bfloat16 v_s[BK * LDH];
    // scores of the tile, then the tile's PV product
    __shared__ __align__(32) float s_s[BQ * LDS];

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int q0 = blockIdx.x * BQ;
    const long long head = (long long)(blockIdx.y / n_head) * stride_b +
                           (long long)(blockIdx.y % n_head) * stride_h;
    const __nv_bfloat16* qh = q + head;
    const __nv_bfloat16* kh = k + head;
    const __nv_bfloat16* vh = v + head;

    // 16-byte loads: 8 bf16 per thread, neighbouring threads on
    // neighbouring addresses; rows past T are zero
    for (int i = tid; i < BQ * (D / 8); i += THREADS) {
        const int r = i / (D / 8);
        const int c = (i % (D / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < t_len)
            val = *reinterpret_cast<const uint4*>(qh + (q0 + r) * stride_t + c);
        *reinterpret_cast<uint4*>(qp_s + r * LDH + c) = val;
    }
    __syncthreads();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(qf[kk], qp_s + warp * 16 * LDH + kk * 16, LDH);

    const int row = tid / 2;        // query row in the tile (warp w: 16w..16w+15)
    const int half = tid % 2;       // which 32 columns of the row
    float* srow = s_s + row * LDS + half * 32;
    __nv_bfloat16* prow = qp_s + row * LDH + half * 32;
    float m_i = -INFINITY;          // running max (log2 units)
    float l_i = 0.0f;               // running sum of exp2
    float acc[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = 0.0f;

    const int n_tiles = (t_len + BK - 1) / BK;
    for (int j = 0; j < n_tiles; ++j) {
        const int k0 = j * BK;
        __syncthreads();            // every warp is done with the last K/V tile
        for (int i = tid; i < BK * (D / 8); i += THREADS) {
            const int r = i / (D / 8);
            const int c = (i % (D / 8)) * 8;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u);
            uint4 vv = make_uint4(0u, 0u, 0u, 0u);
            if (k0 + r < t_len) {
                kv = *reinterpret_cast<const uint4*>(kh + (k0 + r) * stride_t + c);
                vv = *reinterpret_cast<const uint4*>(vh + (k0 + r) * stride_t + c);
            }
            *reinterpret_cast<uint4*>(k_s + r * LDH + c) = kv;
            *reinterpret_cast<uint4*>(v_s + r * LDH + c) = vv;
        }
        __syncthreads();

        // S = Q Kᵀ for this warp's 16 rows; Kᵀ is K read column-major
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
            wmma::fill_fragment(sf, 0.0f);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
                wmma::load_matrix_sync(kf, k_s + n * 16 * LDH + kk * 16, LDH);
                wmma::mma_sync(sf, qf[kk], kf, sf);
            }
            wmma::store_matrix_sync(s_s + warp * 16 * LDS + n * 16, sf, LDS,
                                    wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax; key k0 is always valid, so m_new is finite
        float tile_max = -INFINITY;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
            const bool valid = k0 + half * 32 + c < t_len;
            const float sv = valid ? srow[c] * SCALE_LOG2 : -INFINITY;
            srow[c] = sv;
            tile_max = fmaxf(tile_max, sv);
        }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        const float m_new = fmaxf(m_i, tile_max);
        const float alpha = exp2f(m_i - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
            const float p = exp2f(srow[c] - m_new);
            prow[c] = __float2bfloat16(p);
            psum += p;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        l_i = l_i * alpha + psum;
        m_i = m_new;
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] *= alpha;
        __syncwarp();

        // this tile's P V for the warp's rows, into the score buffer
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
            wmma::fill_fragment(of, 0.0f);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
                wmma::load_matrix_sync(pf, qp_s + warp * 16 * LDH + kk * 16, LDH);
                wmma::load_matrix_sync(vf, v_s + kk * 16 * LDH + n * 16, LDH);
                wmma::mma_sync(of, pf, vf, of);
            }
            wmma::store_matrix_sync(s_s + warp * 16 * LDS + n * 16, of, LDS,
                                    wmma::mem_row_major);
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] += srow[c];
    }

    const int qrow = q0 + row;
    if (qrow < t_len) {
        const float inv = 1.0f / l_i;
        __nv_bfloat16* orow = o + head + qrow * stride_t + half * 32;
#pragma unroll
        for (int c = 0; c < 32; c += 2)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(acc[c] * inv, acc[c + 1] * inv);
    }
}

}  // namespace

// q, k, v, o: (batch, n_head, t_len, 64) bf16 with the same strides (in
// elements) for batch, head and row, unit stride along the 64 columns;
// every row 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int tww_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int batch, int n_head, int t_len,
                                   long long stride_b, long long stride_h,
                                   long long stride_t, void* stream) {
    const dim3 grid((t_len + BQ - 1) / BQ, batch * n_head);
    flash_attention_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n_head,
        t_len, stride_b, stride_h, stride_t);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_flash_attention_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
