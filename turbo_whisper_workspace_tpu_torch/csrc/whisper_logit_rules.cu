// Whisper's decode-time token rules with the sampling reductions after
// them, for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU kernel: the JAX package leaves this to XLA, which fuses
// DecodeRules.apply (turbo_whisper_workspace_tpu/decode/rules.py:87-135)
// with what the decode loop's body does with the masked row: greedy's
// argmax (or Gumbel-max), log_softmax and the sampled token's
// log-probability (decode/greedy.py:118-143), beam's alive_scores +
// log_softmax (decode/beam.py:154-178). Per row of V f32 logits x:
//   m_v = (x_v + static_v) [+ begin_v at the first step]       f32 adds
//   without timestamps: m_v += (v ≥ tsb ? −1e30 : 0)
//   with them, after the first step, m_v = −1e30 where banned:
//     v ≥ tsb after two timestamps; v < eot after one timestamp (not
//     two); tsb ≤ v < ts_floor (monotone timestamps)
//   with them, the timestamp forcing: lse = log Σ_{v ≥ tsb} exp(m_v − M_ts)
//     + M_ts, the non-timestamp entries counted at −1e30 as the torch and
//     JAX versions fill them; if lse > max(max_{v < tsb} m_v, −1e30)
//     every v < tsb becomes −1e30
//   M = max_v f_v,  L = log Σ exp(f_v − M)      (f: the final row)
//   next = first argmax of f_v (or of f_v + T · noise_v: the caller's
//          Gumbel draws), logp = (f_next − M) − L
//   cand_v = add + ((f_v − M) − L)               (beam, when add is given)
// Every element is rounded where torch rounds it (the adds are
// __fadd_rn: nvcc fuses none of them), so only the order of the two sums
// differs from the plain version (ops/whisper_ops.py); a near-tie of the
// forcing test can then flip, which chip_smoke.py counts. The argmax is
// exact. Where every timestamp is masked, M_ts is −1e30 and the sum
// counts the tsb non-timestamp entries as exp(0) = 1 each, exactly as
// torch's logsumexp does.
//
// What bounds it on the H100: a greedy step's 8 rows of 51866 logits
// are 1.7 MB read (the static mask once more, from L2), beam's 40 rows
// 8.3 MB read and written: 0.5-5 µs of bytes, and four dependent
// reductions. Design: a cluster of 8 blocks a row, each block a slice
// of the vocabulary; three passes over the slice (the maxima by side,
// the timestamp sum, then the final row's sum and argmax), each block's
// partials published in shared memory and folded by every block in rank
// order through distributed shared memory (the same order at every call,
// so a replayed graph gives the eager call's bits), a fourth pass writing
// cand; the row stays in L2 between passes. A first design ran a block
// of 1024 threads a row: 42 µs back to back at 8 rows (PERF.md §6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RANKS = 8;               // blocks a row: a cluster, a vocabulary slice each
constexpr float NEG = -1e30f;

struct Rules {
    const float* sm;     // (V,) additive static mask
    const float* bm;     // (V,) additive begin mask, or null after the first step
    int tsb, eot, timestamps;
    bool ban_ts, ban_text;
    long long floor;
};

// m_v: the row's masked value before the timestamp forcing
__device__ __forceinline__ float masked(const float* __restrict__ row, int v, const Rules& r) {
    float x = __fadd_rn(row[v], r.sm[v]);
    if (r.bm != nullptr) x = __fadd_rn(x, r.bm[v]);
    const bool is_ts = v >= r.tsb;
    if (!r.timestamps) return __fadd_rn(x, is_ts ? NEG : 0.0f);
    if (r.bm == nullptr &&
        ((r.ban_ts && is_ts) || (r.ban_text && v < r.eot) || (is_ts && v < r.floor)))
        return NEG;
    return x;
}

// the block's max or sum of v, in one fixed order
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* scratch) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, off);
        v = is_max ? fmaxf(v, o) : v + o;
    }
    __syncthreads();                       // scratch free from the last reduction
    if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
    __syncthreads();
    v = scratch[0];
    for (int w = 1; w < WARPS; ++w) v = is_max ? fmaxf(v, scratch[w]) : v + scratch[w];
    return v;
}

// (value, index) a, b → the larger value, the lower index among equal ones
__device__ __forceinline__ void arg_fold(float& best, int& best_i, float ob, int oi) {
    if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
    }
}

// every rank's published (sum, value, index) folded in rank order, in
// every thread (warp 0 reads the ranks' shared memory, lane c rank c)
__device__ __forceinline__ void cluster_fold(cg::cluster_group& cluster, float* part,
                                             int* part_i, float* fold, int* fold_i) {
    if (threadIdx.x < 32) {
        const int c = threadIdx.x;
        float s = 0.0f, b = -INFINITY;
        int bi = 0x7fffffff;
        if (c < RANKS) {
            s = *cluster.map_shared_rank(part, c);
            b = *cluster.map_shared_rank(part + 1, c);
            bi = *cluster.map_shared_rank(part_i, c);
        }
        float sum = 0.0f, best = -INFINITY;
        int best_i = 0x7fffffff;
        for (int k = 0; k < RANKS; ++k) {
            sum += __shfl_sync(0xffffffffu, s, k);
            arg_fold(best, best_i, __shfl_sync(0xffffffffu, b, k),
                     __shfl_sync(0xffffffffu, bi, k));
        }
        if (c == 0) {
            fold[0] = sum;
            fold[1] = best;
            *fold_i = best_i;
        }
    }
    __syncthreads();
}

__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(THREADS)
rules_kernel(const float* __restrict__ logits, const float* __restrict__ static_mask,
             const float* __restrict__ begin_mask, const long long* __restrict__ last_tok,
             const long long* __restrict__ penult_tok, const long long* __restrict__ ts_floor,
             const float* __restrict__ noise, float temperature, const float* __restrict__ add,
             long long* __restrict__ next_tok, float* __restrict__ tok_logp,
             float* __restrict__ cand, int vocab, int eot, int tsb, int timestamps) {
    __shared__ float scratch[WARPS];
    __shared__ int scratch_i[WARPS];
    __shared__ float part[2], fold[2];     // this rank's partials; their fold over the ranks
    __shared__ int part_i, fold_i;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int row = blockIdx.x / RANKS;
    const int tid = threadIdx.x;
    const int slice = (vocab + RANKS - 1) / RANKS;
    const int v0 = rank * slice;
    const int v1 = min(vocab, v0 + slice);
    const float* x = logits + (size_t)row * vocab;
    const bool last_ts = last_tok[row] >= tsb;
    const bool penult_ts = penult_tok[row] >= tsb;
    const Rules r = {static_mask, begin_mask, tsb, eot, timestamps, last_ts && penult_ts,
                     last_ts && !penult_ts, ts_floor[row]};

    // pass 1: the maxima of the masked row's two sides (order-free)
    float text_max = -INFINITY, ts_max = -INFINITY;
#pragma unroll 4
    for (int v = v0 + tid; v < v1; v += THREADS) {
        const float m = masked(x, v, r);
        if (v < tsb) text_max = fmaxf(text_max, m);
        else ts_max = fmaxf(ts_max, m);
    }
    text_max = block_reduce(text_max, true, scratch);
    ts_max = block_reduce(ts_max, true, scratch);
    if (tid == 0) {
        part[0] = text_max;
        part[1] = ts_max;
    }
    cluster.sync();
    if (tid < 32) {
        float t = -INFINITY, s = -INFINITY;
        for (int c = 0; c < RANKS; ++c) {
            t = fmaxf(t, *cluster.map_shared_rank(part, c));
            s = fmaxf(s, *cluster.map_shared_rank(part + 1, c));
        }
        if (tid == 0) {
            fold[0] = t;
            fold[1] = s;
        }
    }
    cluster.sync();                        // every rank's part read before it is reused
    text_max = fold[0];
    ts_max = fold[1];

    // pass 2 (timestamps): the forcing test on the timestamps' log-sum-exp
    bool force = false;
    if (timestamps) {
        const float m_ts = tsb > 0 ? fmaxf(ts_max, NEG) : ts_max;
        float sum = 0.0f;
        for (int v = max(v0, tsb) + tid; v < v1; v += THREADS) sum += expf(masked(x, v, r) - m_ts);
        sum = block_reduce(sum, false, scratch);
        if (tid == 0) {
            part[0] = sum;
            part[1] = -INFINITY;
            part_i = 0;
        }
        cluster.sync();
        cluster_fold(cluster, part, &part_i, fold, &fold_i);
        cluster.sync();                    // the ranks' parts read before pass 3 writes them
        sum = fold[0];
        if (m_ts == NEG) sum += (float)tsb;      // the filled entries: exp(0) each
        const float lse = logf(sum) + m_ts;
        force = lse > (tsb < vocab ? fmaxf(text_max, NEG) : text_max);
    }
    const float big = force ? (tsb > 0 ? fmaxf(ts_max, NEG) : ts_max) : fmaxf(text_max, ts_max);

    // pass 3: Σ exp(f − M) and the first argmax of f (+ T · noise)
    float sum = 0.0f, best = -INFINITY;
    int best_i = 0x7fffffff;
#pragma unroll 4
    for (int v = v0 + tid; v < v1; v += THREADS) {
        const float f = force && v < tsb ? NEG : masked(x, v, r);
        sum += expf(f - big);
        const float g = noise != nullptr
                            ? __fadd_rn(f, __fmul_rn(temperature, noise[(size_t)row * vocab + v]))
                            : f;
        if (g > best) {
            best = g;
            best_i = v;
        }
    }
    sum = block_reduce(sum, false, scratch);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        arg_fold(best, best_i, __shfl_xor_sync(0xffffffffu, best, off),
                 __shfl_xor_sync(0xffffffffu, best_i, off));
    __syncthreads();
    if (tid % 32 == 0) {
        scratch[tid / 32] = best;
        scratch_i[tid / 32] = best_i;
    }
    __syncthreads();
    if (tid == 0) {
        best = scratch[0];
        best_i = scratch_i[0];
        for (int w = 1; w < WARPS; ++w) arg_fold(best, best_i, scratch[w], scratch_i[w]);
        part[0] = sum;
        part[1] = best;
        part_i = best_i;
    }
    cluster.sync();
    cluster_fold(cluster, part, &part_i, fold, &fold_i);
    cluster.sync();                        // no block leaves while another reads its parts
    const float log_sum = logf(fold[0]);
    if (rank == 0 && tid == 0) {
        const int tok = fold_i < vocab ? fold_i : 0;     // a row of NaN: torch's index 0
        const float f = force && tok < tsb ? NEG : masked(x, tok, r);
        next_tok[row] = tok;
        tok_logp[row] = __fsub_rn(__fsub_rn(f, big), log_sum);
    }
    if (cand != nullptr) {
        const float a = add[row];
        float* out = cand + (size_t)row * vocab;
#pragma unroll 4
        for (int v = v0 + tid; v < v1; v += THREADS) {
            const float f = force && v < tsb ? NEG : masked(x, v, r);
            out[v] = __fadd_rn(a, __fsub_rn(__fsub_rn(f, big), log_sum));
        }
    }
}

}  // namespace

// logits (rows, vocab), noise (rows, vocab) or null, static_mask and
// begin_mask (vocab,) (begin_mask null after the first step), add (rows,)
// or null: f32; last_tok, penult_tok, ts_floor (rows,) int64; next_tok
// (rows,) int64, tok_logp (rows,) f32, cand (rows, vocab) f32 or null
// (with add). All contiguous. 0 < ts_begin ≤ vocab, 0 ≤ eot < vocab.
// Returns cudaGetLastError() after the launch.
extern "C" int tww_whisper_logit_rules(const void* logits, const void* static_mask,
                                       const void* begin_mask, const void* last_tok,
                                       const void* penult_tok, const void* ts_floor,
                                       const void* noise, float temperature, const void* add,
                                       void* next_tok, void* tok_logp, void* cand, int rows,
                                       int vocab, int eot, int ts_begin, int timestamps,
                                       int is_begin, void* stream) {
    if (rows < 1 || rows > 65535 || vocab < 1 || ts_begin < 1 || ts_begin > vocab || eot < 0 ||
        eot >= vocab || (is_begin && begin_mask == nullptr) ||
        ((add == nullptr) != (cand == nullptr)))
        return (int)cudaErrorInvalidValue;
    rules_kernel<<<rows * RANKS, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(logits), static_cast<const float*>(static_mask),
        is_begin ? static_cast<const float*>(begin_mask) : nullptr,
        static_cast<const long long*>(last_tok), static_cast<const long long*>(penult_tok),
        static_cast<const long long*>(ts_floor), static_cast<const float*>(noise), temperature,
        static_cast<const float*>(add), static_cast<long long*>(next_tok),
        static_cast<float*>(tok_logp), static_cast<float*>(cand), vocab, eot, ts_begin,
        timestamps);
    return (int)cudaGetLastError();
}

extern "C" const char* tww_whisper_logit_rules_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
