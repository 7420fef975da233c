// RoPE of the Llama layer's queries and keys, with the keys and values
// written into the layer's cache rows at a device position, for Hopper
// (sm_90a), hand-written CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA, which fuses _rope
// (turbo_whisper_workspace_tpu/models/llama.py:95-108, the half-split
// layout) and the two dynamic_update_slice of the cache (:148-155). Per
// row at position p = pos + r and pair i < dh/2 of a head's dims:
//   x1' = bf16(x1·cos − x2·sin),  x2' = bf16(x2·cos + x1·sin)
// in f32, each product and sum rounded on its own (no fused
// multiply-add), from the (max_ctx, dh/2) f32 cos/sin tables of
// models/llama.py:_rope_rows; the rotated keys go to cache row p of
// every kv head, the values unchanged beside them. pos is an int64 in
// device memory (the decode step a CUDA graph replays) or a host int,
// clamped to [0, S − t]; this replaces the two index_copy_ calls.
//
// What bounds it on the H100: a decode row is 6 KB of q, k and v read
// and written: the launch. Design: one block of 256 threads a (b, row),
// a thread a rotated pair, then the value row copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rope_cache_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t, bf16* __restrict__ q_out,
                  bf16* __restrict__ ck, bf16* __restrict__ cv, int t, int n_head, int n_kv,
                  int dh, int s_len, int max_pos, const long long* __restrict__ pos_at,
                  int pos_host) {
    const int bt = blockIdx.x;
    const int b = bt / t;
    const int r = bt % t;
    long long p = pos_at != nullptr ? *pos_at : (long long)pos_host;
    p = p < 0 ? 0 : (p > s_len - t ? s_len - t : p);
    const int row = (int)p + r;                        // the cache row
    const int trow = row < max_pos ? row : max_pos - 1;   // the table row
    const int half = dh / 2;
    const size_t width = (size_t)n_kv * dh;
    const float* cs = cos_t + (size_t)trow * half;
    const float* sn = sin_t + (size_t)trow * half;
    for (int e = threadIdx.x; e < (n_head + n_kv) * half; e += THREADS) {
        const int head = e / half;
        const int i = e % half;
        const bf16* src;
        bf16* dst;
        if (head < n_head) {
            src = q + ((size_t)bt * n_head + head) * dh;
            dst = q_out + ((size_t)bt * n_head + head) * dh;
        } else {
            src = k + ((size_t)bt * n_kv + head - n_head) * dh;
            dst = ck + ((size_t)b * s_len + row) * width + (size_t)(head - n_head) * dh;
        }
        const float x1 = __bfloat162float(src[i]);
        const float x2 = __bfloat162float(src[i + half]);
        const float c = cs[i];
        const float s = sn[i];
        dst[i] = __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
        dst[i + half] = __float2bfloat16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
    }
    const bf16* vs = v + (size_t)bt * width;
    bf16* vd = cv + ((size_t)b * s_len + row) * width;
    for (int e = threadIdx.x; e < (int)width; e += THREADS) vd[e] = vs[e];
}

}  // namespace

// q, q_out: (batch, t, n_head, dh) bf16; k, v: (batch, t, n_kv, dh) bf16;
// ck, cv: (batch, s_len, n_kv·dh) bf16, one layer's cache; cos, sin:
// (max_pos, dh/2) f32. All contiguous; dh even; 1 ≤ t ≤ s_len. pos: an
// int64 in device memory at pos_at, or the host int `pos` when pos_at
// is null. Returns cudaGetLastError() after the launch.
extern "C" int tww_llama_rope_cache(const void* q, const void* k, const void* v,
                                    const void* cos, const void* sin, void* q_out, void* ck,
                                    void* cv, int batch, int t, int n_head, int n_kv, int dh,
                                    int s_len, int max_pos, const void* pos_at, int pos,
                                    void* stream) {
    if (batch < 1 || t < 1 || t > s_len || dh < 2 || dh % 2 || n_kv < 1 || max_pos < 1 ||
        (long long)batch * t > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    rope_cache_kernel<<<batch * t, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(cos), static_cast<const float*>(sin),
        static_cast<bf16*>(q_out), static_cast<bf16*>(ck), static_cast<bf16*>(cv), t, n_head,
        n_kv, dh, s_len, max_pos, static_cast<const long long*>(pos_at), pos);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_llama_rope_cache_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
