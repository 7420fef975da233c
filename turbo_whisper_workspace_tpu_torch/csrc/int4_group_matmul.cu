// Grouped int4 weight-only matmul (the experts of a prefill) for Hopper
// (sm_90a), hand-written CUDA C++.
//
// No TPU counterpart: the JAX package runs no mixture of experts. It
// computes, in one launch, int4_matmul's product for every expert of a
// DeepSeek-V3 layer over the prompt rows routed to it
// (models/deepseek_v3.py): x (R, K) bf16 holds the rows grouped by expert,
// the weights are the stacked (E, K/2, N) packed int4 (low nibble of byte
// (r, n) is W row r, high nibble row r + K/2, both sign-extended) with (E,
// K/G, N) f32 scales, and a tile table names, for each block row, its
// expert, its first row and its rows (at most 64). Each weight is nibble ×
// scale in f32, rounded once to bf16; the sums are f32 over bf16(x), one
// rounding at the end, as int4_matmul and its plain version compute them.
// With split_n, output columns ≥ split_n go to a second (R, split_n)
// plane: gate and up apart, as llama_swiglu_quant takes them.
//
// What bounds it: at Moonlight's prefill of ~1500 tokens, 8 rows a token
// over 66 experts: ~12000 rows, 2048 → 2816 then 1408 → 2048, 0.2 TFLOP a
// layer, the tensor cores' work. One launch replaces ~130 a layer (one
// int4_matmul per expert and projection, with the host in between).
// Design (first version): one block of 4 warps per 64 × 128 output tile,
// over chunks of 32 rows of K (within one half of the packing and one
// scale group): the next chunk's x and packed bytes load into registers
// while the current one's mma.sync m16n8k16 bf16 products run; a chunk is
// dequantized into shared memory (bf16, [k][n]) and read by ldmatrix.trans.
// Not yet used: wgmma, a cp.async or TMA ring, K split across a cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;                     // rows a tile
constexpr int BN = 128;                    // columns a tile
constexpr int BK = 32;                     // K rows a chunk
constexpr int THREADS = 128;
constexpr int XS = BK + 8;                 // x rows in shared memory: 80 B, no ldmatrix conflicts
constexpr int WS = BN + 8;                 // dequantized rows: 272 B, likewise

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

__global__ void __launch_bounds__(THREADS)
int4_group_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ ws, const int* __restrict__ tiles,
                         bf16* __restrict__ out, int r_total, int k, int n, int n_groups,
                         int split_n) {
    __shared__ __align__(16) bf16 xs[BM * XS];
    __shared__ __align__(16) bf16 wt[BK * WS];
    const int e = tiles[3 * blockIdx.x], r0 = tiles[3 * blockIdx.x + 1];
    const int rows = tiles[3 * blockIdx.x + 2];
    const int n0 = blockIdx.y * BN;
    const int half = k / 2, group = k / n_groups;
    const int8_t* we = w + (long long)e * half * n;
    const float* wse = ws + (long long)e * n_groups * n;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, c4 = lane % 4;
    const int chunks = k / BK;

    // a thread's share of a chunk: 2 of x's 256 16-byte segments (row i / 4,
    // 8 columns i % 4) and 2 of the packed bytes' 256 (row i / 8, 16 columns
    // i % 8) with their 16 scales, for i = tid and tid + 128
    uint4 xv[2], wv[2];
    float4 sv[2][4];
    auto load = [&](int c) {
        const int k0 = c * BK;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = tid + THREADS * s;
            const int r = i / 4, seg = i % 4;
            xv[s] = r < rows ? *reinterpret_cast<const uint4*>(x + (long long)(r0 + r) * k + k0 +
                                                              8 * seg)
                             : make_uint4(0, 0, 0, 0);
            const int pr = i / 8, col = n0 + 16 * (i % 8);
            wv[s] = col < n ? *reinterpret_cast<const uint4*>(we + (long long)(k0 % half + pr) * n +
                                                              col)
                            : make_uint4(0, 0, 0, 0);
            const float4* sc = reinterpret_cast<const float4*>(
                wse + (long long)((k0 + pr) / group) * n + (col < n ? col : 0));
#pragma unroll
            for (int q = 0; q < 4; ++q) sv[s][q] = sc[q];
        }
    };
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const uint32_t xs_addr = (uint32_t)__cvta_generic_to_shared(xs);
    const uint32_t wt_addr = (uint32_t)__cvta_generic_to_shared(wt);

    load(0);
    for (int c = 0; c < chunks; ++c) {
        const int k0 = c * BK;
        const bool high = k0 >= half;
        __syncthreads();                                  // the last chunk's products are done
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = tid + THREADS * s;
            *reinterpret_cast<uint4*>(xs + (i / 4) * XS + 8 * (i % 4)) = xv[s];
            const int pr = i / 8, cl = 16 * (i % 8);
            // row k0 + pr of W, nibble × its group's scale, rounded once
            const bool ok = n0 + cl < n;
            const int8_t* b = reinterpret_cast<const int8_t*>(&wv[s]);
            const float* sc = reinterpret_cast<const float*>(sv[s]);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int v = high ? ((int)b[j] >> 4) : ((int)((unsigned)b[j] << 28) >> 28);
                wt[pr * WS + cl + j] = __float2bfloat16(ok ? __fmul_rn((float)v, sc[j]) : 0.0f);
            }
        }
        __syncthreads();
        if (c + 1 < chunks) load(c + 1);                  // in flight under the products
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, xs_addr + 2 * ((16 * warp + lane % 16) * XS + 16 * kk +
                                          8 * (lane / 16)));
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                uint32_t bv[4];
                const int kr = 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
                ldmatrix_x4_trans(bv, wt_addr + 2 * (kr * WS + 16 * jj + 8 * (lane / 16)));
                mma_bf16(acc[2 * jj], a, bv[0], bv[1]);
                mma_bf16(acc[2 * jj + 1], a, bv[2], bv[3]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * warp + g + 8 * hh;
            const int col = n0 + 8 * j + 2 * c4;
            if (r >= rows || col >= n) continue;
            const long long row = r0 + r;
            bf16* dst = split_n > 0 ? out + ((long long)(col / split_n) * r_total + row) *
                                                  split_n + col % split_n
                                    : out + row * n + col;
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
        }
    }
}

}  // namespace

// x (r_total, k) bf16, 16-byte aligned rows; w (E, k/2, n) packed int8 and
// ws (E, n_groups, n) f32, 16-byte aligned; tiles (n_tiles, 3) int32
// (expert, first row, rows ≤ 64); out (r_total, n) bf16, or with split_n
// > 0 (2, r_total, split_n) (n = 2·split_n, split_n even). k a multiple
// of 64 whose groups k / n_groups are multiples of 32; n a multiple of 16.
// Returns cudaGetLastError() after the launch.
extern "C" int tww_int4_group_matmul(const void* x, const void* w, const void* ws,
                                     const void* tiles, void* out, int n_tiles, int r_total,
                                     int k, int n, int n_groups, int split_n, void* stream) {
    if (n_tiles < 1 || n_tiles > 0x7fffffff || k % 64 || n_groups < 1 || k % n_groups ||
        (k / n_groups) % BK || n % 16 || (n + BN - 1) / BN > 65535 ||
        (split_n > 0 && (2 * split_n != n || split_n % 2)))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(n_tiles, (n + BN - 1) / BN);
    int4_group_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(ws),
        static_cast<const int*>(tiles), static_cast<bf16*>(out), r_total, k, n, n_groups,
        split_n);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_int4_group_matmul_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
