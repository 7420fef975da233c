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
// it is compute-bound: the two products must run on the tensor cores at
// their Hopper rate (wgmma), the softmax between them must stay in
// registers, and the (T, T) score matrix must never reach HBM or even
// shared memory.
//
// Design: one block of two consumer warpgroups per (b·h, 128-row Q
// tile); each warpgroup owns 64 query rows. The Q tile and a ring of
// STAGES 64-key K/V tiles live in shared memory in the 128-byte swizzle
// (a head row of 64 bf16 is exactly 128 bytes), filled by 16-byte
// cp.async copies: tiles j + 1 .. j + 3 are in flight while tile j's two
// products run. Rows past T are zero-filled by the copy
// (source size 0). cp.async rather than TMA: a tensor map needs
// cuTensorMapEncodeTiled from libcuda (ops/build.py links none) and a
// map per call for the encoder's strided (B, T, H·64) views; the copies
// cost 4 instructions a thread a tile against 8 wgmma, and keep the
// build a plain nvcc of one file.
//   S = Q Kᵀ: 4 wgmma m64n64k16 per warpgroup, Q (A) and K (B) both
// K-major from shared memory, f32 sums in registers.
//   Softmax on the accumulator fragment: each thread holds 2 rows × 16
// columns; the row max takes two quad shuffles, the running max and
// per-thread partial sums are rescaled with exp2 (the sums meet across
// the quad once, at the end). Keys ≥ T are masked in the ragged last
// tile (1500 = 23·64 + 28).
//   O += P V: P is rounded to bf16 in registers, where the f32
// accumulator layout of S is exactly the k16 A-fragment layout of the
// next product, and fed to wgmma from registers (no shared memory); V is
// the B operand read MN-major (transposed) from the same swizzled tile.
// PV is left in flight while the next tile's copies are issued and its
// Q Kᵀ runs (the ring frees a stage two tiles after its use for that).
// exp2 is one ex2.approx with the scale folded into an FMA: at d = 64 the
// exponentials cost about as many cycles as the products.
//   The output is normalised once at the end and written bf16; rows ≥ T
// are not written. q, k, v and o are addressed through (batch, head,
// row) strides, so the encoder passes its (B, T, H·64) projections as
// they are. Not yet used: a producer warp, ping-pong between the two
// warpgroups, persistent blocks, fp8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int D = 64;                    // head dim: one 128-byte row
constexpr int WG = 2;                    // consumer warpgroups per block
constexpr int BQ = 64 * WG;              // query rows per block
constexpr int BK = 64;                   // keys per K/V tile
constexpr int STAGES = 5;                // K/V ring depth
constexpr int AHEAD = STAGES - 2;        // tiles in flight ahead of the one in use
constexpr int THREADS = 128 * WG;
constexpr int TILE = 64 * 128;           // bytes of one 64-row tile
constexpr int SMEM_BYTES = (WG + 2 * STAGES) * TILE + 1024;   // + 1024-byte alignment
// d^-1/2 · log2(e): softmax through exp2
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;

static_assert(D * 2 == 128, "a head row must fill one 128-byte swizzle row");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows row0.. of a head (64 rows × 64 bf16) into a swizzled tile at dst:
// 16-byte chunk c of row r lands at chunk c ^ (r % 8); rows ≥ t_len are
// zero-filled (no bytes read)
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* head, int row0,
                                          int t_len, long long stride_t, int tid) {
#pragma unroll
    for (int i = tid; i < 64 * 8; i += THREADS) {
        const int r = i / 8;
        const int c = i % 8;
        const int row = row0 + r;
        const bool ok = row < t_len;
        cp_async16(dst + r * 128 + ((c ^ (r % 8)) << 4),
                   head + (long long)(ok ? row : 0) * stride_t + c * 8, ok ? 16u : 0u);
    }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 in bits
// 62-63. Tiles are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
           (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous products, and keeps an A fragment's
// registers alive until the product that reads them is waited for
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

#define TWW_ACC32(d)                                                                     \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
        "+f"(d[31])
#define TWW_D32                                                                \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 f32) = [d +] A (64x16 bf16, K-major in shared memory) ·
// B (16x64 bf16, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TWW_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : TWW_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64x64 f32) += A (64x16 bf16 in registers: the k16 A fragment) ·
// B (16x64 bf16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TWW_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : TWW_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int n_head, int t_len,
                       long long stride_b, long long stride_h, long long stride_t) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_s = base;                    // WG tiles of 64 query rows
    const uint32_t kv_s = base + WG * TILE;       // stage s: K at +2s·TILE, V after it

    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;            // warp in the warpgroup: 16 rows
    const int lane = tid % 32;
    const int q0 = blockIdx.x * BQ;
    const long long head = (long long)(blockIdx.y / n_head) * stride_b +
                           (long long)(blockIdx.y % n_head) * stride_h;
    const __nv_bfloat16* qh = q + head;
    const __nv_bfloat16* kh = k + head;
    const __nv_bfloat16* vh = v + head;
    const int n_tiles = (t_len + BK - 1) / BK;

    // prologue: the Q tile with K/V tile 0, then tiles 1..AHEAD-1, one
    // commit group per tile (empty groups keep the count uniform)
#pragma unroll
    for (int w = 0; w < WG; ++w) load_tile(q_s + w * TILE, qh, q0 + 64 * w, t_len, stride_t, tid);
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < n_tiles) {
            load_tile(kv_s + 2 * s * TILE, kh, s * BK, t_len, stride_t, tid);
            load_tile(kv_s + (2 * s + 1) * TILE, vh, s * BK, t_len, stride_t, tid);
        }
        cp_async_commit();
    }

    // this thread's rows of the warpgroup's 64 (r and r + 8) and columns
    // 8j + 2·(lane % 4) + {0, 1} of each accumulator
    const int quad_col = 2 * (lane % 4);
    float o_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.0f;
    uint32_t p_frag[4][4];                        // P of the tile whose PV is in flight
    float m_run[2] = {-INFINITY, -INFINITY};      // running max (log2 units)
    float l_run[2] = {0.0f, 0.0f};                // this thread's share of the running sum
    const uint64_t desc_q = smem_desc(q_s + wg * TILE, 16, 1024);

    for (int j = 0; j < n_tiles; ++j) {
        cp_async_wait<AHEAD - 1>();               // tile j has landed (this thread's copies)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        // everyone's copies are visible; tile j - 2's stage is free: both
        // warpgroups waited for its PV during iteration j - 1
        __syncthreads();
        {
            const int nxt = j + AHEAD;
            if (nxt < n_tiles) {
                const int s = nxt % STAGES;
                load_tile(kv_s + 2 * s * TILE, kh, nxt * BK, t_len, stride_t, tid);
                load_tile(kv_s + (2 * s + 1) * TILE, vh, nxt * BK, t_len, stride_t, tid);
            }
            cp_async_commit();
        }
        const uint32_t k_tile = kv_s + 2 * (j % STAGES) * TILE;
        const uint32_t v_tile = k_tile + TILE;

        // S = Q Kᵀ: four k16 steps, 32 bytes apart inside the swizzled rows;
        // the wait also completes the last tile's PV, still in flight
        float s_acc[32];
        fence_regs(s_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(s_acc, desc_q + 2 * kk, smem_desc(k_tile + 32 * kk, 16, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s_acc);
        fence_regs(o_acc);
        fence_regs(p_frag);

        // online softmax on the fragment, on raw scores (the scale is
        // positive, so it commutes with the max); key k0 is always valid,
        // so each row's new max is finite
        const int k0 = j * BK;
        if (k0 + BK > t_len) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
                if (k0 + 8 * (i / 4) + quad_col + (i % 2) >= t_len) s_acc[i] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s_acc[i]);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            const float m_new = fmaxf(m_run[h], mx[h] * SCALE_LOG2);
            alpha[h] = ex2(m_run[h] - m_new);
            m_run[h] = m_new;
            l_run[h] *= alpha[h];
        }
        // P = exp2(s·scale − m), unnormalised, as bf16 A fragments: k16
        // step kk holds columns 16kk..16kk+15, accumulator chunks 2kk, 2kk + 1
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = 8 * kk + 2 * r;     // r: (row, chunk) = (r % 2, r / 2)
                const float p0 = ex2(fmaf(s_acc[i], SCALE_LOG2, -m_run[r % 2]));
                const float p1 = ex2(fmaf(s_acc[i + 1], SCALE_LOG2, -m_run[r % 2]));
                l_run[r % 2] += p0 + p1;
                p_frag[kk][r] = pack_bf16(p0, p1);
            }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i / 2) % 2];

        // O += P V, left in flight into the next iteration: V's 16-key
        // slices are 2048 bytes apart (two 8-row swizzle atoms); MN-major,
        // so the 8-row groups are 1024 bytes apart
        fence_regs(o_acc);
        fence_regs(p_frag);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs(o_acc, p_frag[kk], smem_desc(v_tile + 2048 * kk, 1024, 1024));
        wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(o_acc);
    fence_regs(p_frag);
    cp_async_wait<0>();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= t_len) continue;
        const float inv = 1.0f / l_run[h];
        __nv_bfloat16* orow = o + head + (long long)row * stride_t + quad_col;
#pragma unroll
        for (int c = 0; c < 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(
                o_acc[4 * c + 2 * h] * inv, o_acc[4 * c + 2 * h + 1] * inv);
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
    static bool raised = false;      // the shared-memory attribute, once
    if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const dim3 grid((t_len + BQ - 1) / BQ, batch * n_head);
    flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n_head,
        t_len, stride_b, stride_h, stride_t);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_flash_attention_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
