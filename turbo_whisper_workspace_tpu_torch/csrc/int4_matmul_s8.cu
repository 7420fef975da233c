// W4A8 matmul (int8 activations × grouped int4 weights) for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel turbo_whisper_workspace_tpu/ops/quant.py:
// int4_matmul_s8 (body _s8g4_kernel, pallas_call at :275). xq (M, K) int8
// with per-(row, group) scales xs (M, n_groups) f32; the weight packed as
// for int4_matmul: (K/2, N) int8, low nibble row r, high nibble row
// r + K/2, sign-extended, scales ws (n_groups, N) f32. For each group g
// (G = K/n_groups rows) an exact s32 dot d_g = Σ xq·w, then, groups in
// order, acc = acc + d_g · (xs[m, g] · ws[g, n]) in f32; out bf16.
//
// What bounds it on the H100: on the LLM's path it is every body
// projection of every decode step, M = 1: a GEMV that reads every packed
// weight byte once, about 2 integer operations per byte. It is bound by
// HBM: at (K, N) = (4096, 14336), 29.4 MB of nibbles plus 1.8 MB of
// scales → 9.3 µs at 3.35 TB/s; one decode step's 224 projections read
// about 3.7 GB → 1.11 ms. So the design keeps enough bytes in flight to
// fill HBM (about 40 KB per SM), spends few instructions per byte, and
// launches once per call.
//
// Design: one launch. A warp's lanes are 8 along N × 4 along the packed
// rows; a lane reads 16 bytes (16 columns) of 4 consecutive packed rows
// at a time, so a warp reads 128-byte row segments, in batches of 2 row
// quads; the next batch's 8 loads are issued before a batch is computed
// (8-16 loads, 128-256 bytes in flight a lane, all the time). The 4x4
// byte blocks are transposed with __byte_perm (int8_blocks.cuh); a
// nibble plane, masked in place ((b << 4) & 0xF0 and b & 0xF0), is the
// signed nibble times 16 as an s8, so one dp4a per column per plane
// takes 4 rows against the 4 xq bytes of those rows (read from shared
// memory, where the block stages its xq bytes and xs values once, and
// its ws rows by cp.async while the sweep runs), and the exact sum is
// shifted right by 4 at the end: about 30 warp instructions per 512
// bytes at M = 1. A block (8 warps, 128 columns) takes a range of group
// pairs (the G packed rows whose low nibbles are
// group p and high nibbles group p + n_groups/2); a pair's row quads are
// spread over the warps that share it, whose s32 partial sums meet
// exactly (integer adds, any order) through warp shuffles and shared
// atomics. Each (group, row, column) term d · (xs · ws) is then rounded
// as the TPU kernel rounds it (no fused multiply-add).
//   Where the block holds every group of its column tile (the wrapper's
// plan does so when the tiles alone fill the card, e.g. N = 14336), the
// terms stay in shared memory and the block folds them in group order.
// Otherwise K is split over the ranks of a thread-block cluster (at most
// 8, the portable size): the blocks of one (column tile, chunk of 8 rows
// of M) take contiguous runs of group pairs, and the plan keeps the grid
// within the clusters the card holds at once, so it runs in one wave.
// Each rank sends every term of its groups into the shared memory of the
// rank that folds that column (rank r folds the tile's r-th run of
// 128 / splits columns), through distributed shared memory; after one
// cluster barrier each output adds its n_groups terms in group order from
// its own shared memory, with the same rounding as the unsplit fold. No
// scratch in device memory, no atomics across blocks: only the output is
// written. Rows of M go in chunks of 8 across the grid, 1 or 2 at a time
// through a warp's sweep. Where N is not a multiple of 16 (or w not
// 16-byte aligned), lanes read 4 bytes instead. Not yet used: a
// cp.async/TMA ring, persistent blocks. The sweep lives in int4_s8.cuh,
// which the expert product (int4_moe_s8.cu) shares.

#include "int4_s8.cuh"

namespace {

template <int MC, int CG>
__global__ void __launch_bounds__(THREADS, MC == 1 ? 2 : 1)   // M = 1: 2 blocks an SM
int4_matmul_s8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const int8_t* __restrict__ w, const float* __restrict__ ws,
                      __nv_bfloat16* __restrict__ out, int m, int k, int n, int n_groups,
                      int pb) {
    s8_sweep<MC, CG, false>(xq, xs, w, ws, out, m, k, n, n_groups, pb,
                            ExpertRows{nullptr, 1, 0, 0});
}

// Raises the instance's dynamic shared-memory limit, once, where a
// launch needs more than 48 KB
template <int MC, int CG>
int prepare(int smem) {
    static bool raised = false;
    if (smem > 48 * 1024 && !raised) {
        const cudaError_t e = cudaFuncSetAttribute(
            int4_matmul_s8_kernel<MC, CG>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (e != cudaSuccess) return (int)e;
        raised = true;
    }
    return 0;
}

template <int MC, int CG>
int launch(const int8_t* xq, const float* xs, const int8_t* w, const float* ws,
           __nv_bfloat16* out, int m, int k, int n, int n_groups, int pb, cudaStream_t stream) {
    int smem;
    dim3 grid;
    int err = s8_shape<CG>(m, k, n, n_groups, pb, M_CHUNK, smem, grid);
    if (!err) err = prepare<MC, CG>(smem);
    if (err) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = s8_config(grid, smem, stream, attr);
    err = (int)cudaLaunchKernelEx(&cfg, int4_matmul_s8_kernel<MC, CG>, xq, xs, w, ws, out, m, k,
                                  n, n_groups, pb);
    return err ? err : (int)cudaGetLastError();
}

// The clusters of this launch the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 without a split of K
template <int MC, int CG>
int clusters(int m, int k, int n, int n_groups, int pb) {
    int smem;
    dim3 grid;
    if (s8_shape<CG>(m, k, n, n_groups, pb, M_CHUNK, smem, grid) || prepare<MC, CG>(smem))
        return -2;
    if (grid.y == 1) return -1;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = s8_config(grid, smem, nullptr, attr);
    int count = 0;
    if (cudaOccupancyMaxActiveClusters(&count, int4_matmul_s8_kernel<MC, CG>, &cfg) !=
        cudaSuccess)
        return -2;
    return count;
}

}  // namespace

// xq (m, k) int8 (4-byte aligned), xs (m, n_groups) f32, w (k/2, n)
// packed int8, ws (n_groups, n) f32, out (m, n) bf16; all dense, n a
// multiple of 4, n_groups even and dividing k, k / n_groups a multiple of
// 4. pairs_per_block: group pairs a block takes (n_groups / 2 for no
// split; otherwise the split, ceil(n_groups / 2 / pairs_per_block) ranks,
// is one cluster of at most 8). Returns cudaGetLastError() after the
// launch.
extern "C" int tww_int4_matmul_s8(const void* xq, const void* xs, const void* w,
                                  const void* ws, void* out, int m, int k, int n, int n_groups,
                                  int pairs_per_block, void* stream) {
    const auto* xq_ = static_cast<const int8_t*>(xq);
    const auto* xs_ = static_cast<const float*>(xs);
    const auto* w_ = static_cast<const int8_t*>(w);
    const auto* ws_ = static_cast<const float*>(ws);
    auto* out_ = static_cast<__nv_bfloat16*>(out);
    const auto s = (cudaStream_t)stream;
    const int pb = pairs_per_block;
    if (pb < 1 || pb > n_groups / 2) return (int)cudaErrorInvalidValue;
    // 16-byte loads where every row segment is 16-byte aligned
    const bool wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (m == 1)
        return wide ? launch<1, 4>(xq_, xs_, w_, ws_, out_, m, k, n, n_groups, pb, s)
                    : launch<1, 1>(xq_, xs_, w_, ws_, out_, m, k, n, n_groups, pb, s);
    return wide ? launch<2, 4>(xq_, xs_, w_, ws_, out_, m, k, n, n_groups, pb, s)
                : launch<2, 1>(xq_, xs_, w_, ws_, out_, m, k, n, n_groups, pb, s);
}

// The clusters of the launch tww_int4_matmul_s8 makes for these arguments
// (w 16-byte aligned) that the card holds at once; -1 where it does not
// split K, -2 where it would refuse the plan.
extern "C" int tww_int4_matmul_s8_clusters(int m, int k, int n, int n_groups,
                                           int pairs_per_block) {
    if (pairs_per_block < 1 || pairs_per_block > n_groups / 2) return -2;
    const bool wide = n % 16 == 0;
    if (m == 1)
        return wide ? clusters<1, 4>(m, k, n, n_groups, pairs_per_block)
                    : clusters<1, 1>(m, k, n, n_groups, pairs_per_block);
    return wide ? clusters<2, 4>(m, k, n, n_groups, pairs_per_block)
                : clusters<2, 1>(m, k, n, n_groups, pairs_per_block);
}

extern "C" const char* tww_int4_matmul_s8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
