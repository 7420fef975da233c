// The Whisper decoder's K/V cache writes, with the int8 row quantizer,
// for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA, which fuses
// `_quantize_kv_rows` (turbo_whisper_workspace_tpu/models/whisper.py:
// 420-430) with the dynamic_update_slice writes of one layer's new rows
// into its cache (:518-545 the lane panels, :568-580 the int8 cache,
// :604-605 the bf16 cache) inside the jitted decode loop. One launch
// writes this call's K and V rows (B, t, D) bf16 at positions p..p+t-1
// of one layer (p clamped into [0, S − t]):
//   mode 0, bf16 cache: ck, cv (B, S, D)      ← the rows as they are
//   mode 1, int8 cache: k_q, v_q (B, H, S, Dh) int8, k_s, v_s (B, H, S) bf16
//   mode 2, beam lanes (t = 1, row b·K + k writes lane k of item b):
//     k_p (B/K, H·Dh, K, S), v_p (B/K, K, S, H·Dh) int8,
//     k_ps, v_ps (B/K, H, K, S) bf16
// The quantizer of each (row, head): s = max(amax / 127, 1e-8) in f32,
// q = clamp(rint(x / s), ±127) with IEEE divisions (round half to even),
// the scale rounded to bf16 only after the divisions: bit-equal to
// ops/whisper_ops.py:quantize_kv_rows on the card.
//
// What bounds it on the H100: a greedy step writes 8 rows × 2 × 1280
// values a layer (~40 KB): the launch. Design: a warp per (row, head),
// Dh/32 values a lane, the |max| a warp shuffle; K and V in the same
// warp; the lane panel's K column written a byte at a stride of K·S (the
// JAX layout, which self_attention_int8_lanes reads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DH = 128;
constexpr int VPL = MAX_DH / 32;       // values a lane at most

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// one (row, head) of K or V: x[d] for d = lane + 32·i
struct Row {
    float x[VPL];
};

__device__ __forceinline__ Row load_row(const bf16* src, int lane, int dh) {
    Row r;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int d = lane + 32 * i;
        r.x[i] = d < dh ? __bfloat162float(src[d]) : 0.0f;
    }
    return r;
}

// the row's int8 values into dst[d · stride] and its bf16 scale into *scale
__device__ __forceinline__ void quantize_store(const Row& r, int lane, int dh, int8_t* dst,
                                               size_t stride, bf16* scale) {
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) amax = fmaxf(amax, fabsf(r.x[i]));
    amax = warp_max(amax);
    const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) {
            const float q = fminf(fmaxf(rintf(__fdiv_rn(r.x[i], s)), -127.0f), 127.0f);
            dst[(size_t)d * stride] = (int8_t)q;
        }
    }
    if (lane == 0) *scale = __float2bfloat16(s);
}

__global__ void __launch_bounds__(THREADS)
kv_rows_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v, void* __restrict__ dk,
               void* __restrict__ dv, bf16* __restrict__ dks, bf16* __restrict__ dvs, int mode,
               int batch, int t, int n_head, int dh, int s_len, int beam,
               const long long* __restrict__ pos_at, int pos) {
    const int lane = threadIdx.x % 32;
    const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    if (w >= (long long)batch * t * n_head) return;
    const int h = (int)(w % n_head);
    const int ti = (int)((w / n_head) % t);
    const int b = (int)(w / ((long long)n_head * t));
    long long p0 = pos_at != nullptr ? *pos_at : (long long)pos;
    p0 = p0 < 0 ? 0 : (p0 > s_len - t ? s_len - t : p0);
    const int p = (int)p0 + ti;
    const int d_model = n_head * dh;
    const size_t src = ((size_t)b * t + ti) * d_model + (size_t)h * dh;
    if (mode == 0) {
        const size_t dst = ((size_t)b * s_len + p) * d_model + (size_t)h * dh;
        for (int d = lane; d < dh; d += 32) {
            static_cast<bf16*>(dk)[dst + d] = k[src + d];
            static_cast<bf16*>(dv)[dst + d] = v[src + d];
        }
        return;
    }
    const Row rk = load_row(k + src, lane, dh);
    const Row rv = load_row(v + src, lane, dh);
    int8_t* kq = static_cast<int8_t*>(dk);
    int8_t* vq = static_cast<int8_t*>(dv);
    if (mode == 1) {
        const size_t row = ((size_t)b * n_head + h) * s_len + p;
        quantize_store(rk, lane, dh, kq + row * dh, 1, dks + row);
        quantize_store(rv, lane, dh, vq + row * dh, 1, dvs + row);
        return;
    }
    const int bi = b / beam;
    const int kl = b % beam;
    const size_t scale = (((size_t)bi * n_head + h) * beam + kl) * s_len + p;
    quantize_store(rk, lane, dh,
                   kq + (((size_t)bi * d_model + (size_t)h * dh) * beam + kl) * s_len + p,
                   (size_t)beam * s_len, dks + scale);
    quantize_store(rv, lane, dh,
                   vq + (((size_t)bi * beam + kl) * s_len + p) * d_model + (size_t)h * dh, 1,
                   dvs + scale);
}

}  // namespace

// k, v: (batch, t, n_head·head_dim) bf16, this call's rows; dk, dv, dks,
// dvs: one layer of the cache of `mode` (the layouts above; dks, dvs
// unused in mode 0), all contiguous. Mode 2: t = 1 and batch a multiple
// of beam. head_dim ≤ 128; 1 ≤ t ≤ s_len. pos: an int64 in device memory
// at pos_at, or the host int `pos` when pos_at is null; clamped to
// [0, s_len − t]. Returns cudaGetLastError() after the launch.
extern "C" int tww_whisper_kv_rows(const void* k, const void* v, void* dk, void* dv, void* dks,
                                   void* dvs, int mode, int batch, int t, int n_head,
                                   int head_dim, int s_len, int beam, const void* pos_at,
                                   int pos, void* stream) {
    if (batch < 1 || t < 1 || t > s_len || n_head < 1 || head_dim < 1 ||
        head_dim > MAX_DH || mode < 0 || mode > 2 ||
        (mode == 2 && (t != 1 || beam < 1 || batch % beam)))
        return (int)cudaErrorInvalidValue;
    const long long warps = (long long)batch * t * n_head;
    kv_rows_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0,
                     (cudaStream_t)stream>>>(
        static_cast<const bf16*>(k), static_cast<const bf16*>(v), dk, dv,
        static_cast<bf16*>(dks), static_cast<bf16*>(dvs), mode, batch, t, n_head, head_dim,
        s_len, beam < 1 ? 1 : beam, static_cast<const long long*>(pos_at), pos);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_whisper_kv_rows_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
