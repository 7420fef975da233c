// The experts' W4A8 product (int8 activations × grouped int4 weights, one
// expert a row) for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU counterpart: the JAX package runs no mixture-of-experts model.
// It serves the DeepSeek-V3 decode step (models/deepseek_v3.py): row r of
// the output is int4_matmul_s8's product of activation row r / x_div
// with expert ids[r]'s weight, read from the stacked (E, K/2, N) packed
// weights and (E, n_groups, N) scales. The ids are a device tensor the
// router wrote in the same step: a CUDA graph freezes this launch, and
// each block reads its row's expert on entry, so the host never learns
// which experts ran. At the Moonlight decode step (batch 1) the rows are
// the token's 6 routed experts and its 2 shared ones: gate|up is one
// launch of 8 rows, 2048 → 2816 (x_div 8: the rows share the token's
// quantized input; split_n 1408 writes gate and up as two dense (8,
// 1408) planes for llama_swiglu_quant), down another, 1408 → 2048 in
// groups of 64.
//
// What bounds it: the chosen experts' bytes, 2.9 MB (gate|up) and 1.6 MB
// (down, with its 64-row groups' scales) a row, each read once: 37 MB a
// layer, 11 µs at 3.35 TB/s. Design: int4_matmul_s8's sweep (int4_s8.cuh)
// with one output row a block (blockIdx.z), since no two rows of a
// decode token share an expert; the plan (ops/quant.py:s8_pairs_per_block
// with rows_per_block 1) keeps every group in a block when the column
// tiles of all rows fill the card, and otherwise splits K over a cluster
// with the same fold across its ranks (a cluster's blocks share one
// output row, so they read one expert). The arithmetic and its rounding
// are the dense kernel's, row by row.

#include "int4_s8.cuh"

namespace {

template <int CG>
__global__ void __launch_bounds__(THREADS, 2)
int4_moe_s8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int rows, int k, int n, int n_groups, int pb,
                   const ExpertRows expert_rows) {
    s8_sweep<1, CG, true>(xq, xs, w, ws, out, rows, k, n, n_groups, pb, expert_rows);
}

template <int CG>
int launch(const int8_t* xq, const float* xs, const int8_t* w, const float* ws,
           __nv_bfloat16* out, int rows, int k, int n, int n_groups, int pb,
           const ExpertRows expert_rows, cudaStream_t stream) {
    int smem;
    dim3 grid;
    const int err = s8_shape<CG>(rows, k, n, n_groups, pb, 1, smem, grid);
    if (err) return err;
    static bool raised = false;                       // the attribute, once per instance
    if (smem > 48 * 1024 && !raised) {
        const cudaError_t e = cudaFuncSetAttribute(
            int4_moe_s8_kernel<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (e != cudaSuccess) return (int)e;
        raised = true;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = s8_config(grid, smem, stream, attr);
    const int code = (int)cudaLaunchKernelEx(&cfg, int4_moe_s8_kernel<CG>, xq, xs, w, ws, out,
                                             rows, k, n, n_groups, pb, expert_rows);
    return code ? code : (int)cudaGetLastError();
}

}  // namespace

// xq (rows / x_div, k) int8 (4-byte aligned), xs (rows / x_div, n_groups)
// f32, ids (rows,) int64 expert ids, w (n_experts, k/2, n) packed int8,
// ws (n_experts, n_groups, n) f32; out (rows, n) bf16, or with split_n > 0
// two planes (2, rows, split_n) (n = 2·split_n). Constraints and the
// split of K as for tww_int4_matmul_s8. Returns cudaGetLastError() after
// the launch.
extern "C" int tww_int4_moe_s8(const void* xq, const void* xs, const void* w, const void* ws,
                               const void* ids, void* out, int rows, int x_div, int k, int n,
                               int n_groups, int pairs_per_block, int split_n, int n_experts,
                               void* stream) {
    const auto* xq_ = static_cast<const int8_t*>(xq);
    const auto* xs_ = static_cast<const float*>(xs);
    const auto* w_ = static_cast<const int8_t*>(w);
    const auto* ws_ = static_cast<const float*>(ws);
    auto* out_ = static_cast<__nv_bfloat16*>(out);
    const auto s = (cudaStream_t)stream;
    const int pb = pairs_per_block;
    if (pb < 1 || pb > n_groups / 2 || x_div < 1 || n_experts < 1 ||
        (split_n > 0 && 2 * split_n != n))
        return (int)cudaErrorInvalidValue;
    const ExpertRows expert_rows{static_cast<const long long*>(ids), x_div, split_n, n_experts};
    // 16-byte loads where every row segment of every expert is 16-byte aligned
    const bool wide = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    return wide ? launch<4>(xq_, xs_, w_, ws_, out_, rows, k, n, n_groups, pb, expert_rows, s)
                : launch<1>(xq_, xs_, w_, ws_, out_, rows, k, n, n_groups, pb, expert_rows, s);
}

extern "C" const char* tww_int4_moe_s8_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
