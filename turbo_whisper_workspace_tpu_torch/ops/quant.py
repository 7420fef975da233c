"""Weight quantization and the quantized-matmul kernels of the LLM.

Port of turbo_whisper_workspace_tpu/ops/quant.py: symmetric
per-output-channel int8 (`quantize_int8`), grouped int4 packed two rows
to a byte (`quantize_int4`: the LOW nibbles hold rows [0, K/2), the HIGH
nibbles rows [K/2, K); one f32 scale per (group of GROUP4 rows, column)),
`quantize_tree` (the Q4 point: int4 body, int8 `lm_head`), the grouped
int8 activation quantizer of the W4A8 path, and `matmul_any`, which
routes a projection by its weight format and its row count. The LLM
families' layers (models/llama.py, models/deepseek_v3.py) ask this module
which of their int4 projections share one quantized input
(`w4a8_groups`) and join their int4 siblings (`join_int4`).

Three kernels, each with a wrapper and a plain PyTorch version beside it:

* `int8_matmul`    x @ (int8 W · bf16 scale), csrc/int8_matmul.cu (a
  split-K GEMV at decode rows, wgmma on dequantized tiles above);
* `int4_matmul`    x @ dequant4(W), csrc/int4_matmul.cu;
* `int4_matmul_s8` W4A8: int8 activations × int4 weights, exact s32 sums
  per group, csrc/int4_matmul_s8.cu;

and, with no TPU counterpart, the DeepSeek-V3 experts' two: `int4_moe_s8`,
int4_matmul_s8's product with each output row's weight picked from
stacked experts by a device tensor of expert ids (csrc/int4_moe_s8.cu,
the decode step), and `int4_group_matmul`, int4_matmul's product of
each expert over its group of rows in one launch
(csrc/int4_group_matmul.cu, the prefill).

For CUDA tensors a wrapper checks them, allocates the output, launches
its kernel on the current stream and counts the launch in
`launch_counts`; for CPU tensors it runs the plain version; anything
else raises. The quantizers run on the device their input lies on; on
the CPU their payloads and scales are bit-equal to the JAX package's
numpy versions (f32 division, round half to even, clip).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .attention import _div
from .build import _check_cuda, _stream, count_launch

GROUP4 = 128
# rows up to which an int4 projection runs W4A8 (int4_matmul_s8 over the
# rows quantized to int8 in groups), as the JAX package's TPU route does
W4A8_MAX_M = 8

# kernel name → launches since the last reset_launch_counts()
launch_counts = {name: 0 for name in ("int8_matmul", "int4_matmul", "int4_matmul_s8",
                                      "int4_moe_s8", "int4_group_matmul")}
# "<kernel>.cluster" → the kernel's launches that split K over a
# thread-block cluster, counted as launch_counts counts launches (a name
# of its own: a graph capture's record of launches is keyed by name)
cluster_launch_counts = {"int4_matmul_s8.cluster": 0, "int4_moe_s8.cluster": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, cluster_launch_counts):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# Quantizers


def quantize_int8(w: torch.Tensor) -> dict:
    """(K, N) or layer-stacked (L, K, N) float → {"w_q": int8, "scale":
    f32 (N,) / (L, N)}, symmetric per output channel."""
    wf = w.float()
    scale = _div(wf.abs().amax(dim=-2), 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return {"w_q": q.to(torch.int8), "scale": scale}


def quantize_int4(w: torch.Tensor, group: int = GROUP4) -> dict:
    """(K, N) or layer-stacked (L, K, N) float → {"w_q4": int8 (…, K/2, N)
    packed, "scale4": f32 (…, K/group, N)}, symmetric per (group, column).
    K must be divisible by 2·group."""
    wf = w.float()
    k, n = wf.shape[-2:]
    if k % (2 * group):
        raise ValueError(f"K={k} not divisible by 2*group={2 * group}")
    wg = wf.reshape(*wf.shape[:-2], k // group, group, n)
    scale = _div(wg.abs().amax(dim=-2), 7.0).clamp_min(1e-12)        # (…, K/G, N)
    q = torch.clamp(torch.round(wg / scale.unsqueeze(-2)), -7, 7).reshape(wf.shape)
    q = q.to(torch.int32)
    lo, hi = q[..., : k // 2, :], q[..., k // 2:, :]
    packed = (lo & 0x0F) | (hi << 4)       # in [-128, 127]: exact in int8
    return {"w_q4": packed.to(torch.int8), "scale4": scale}


def quantize_tree(params, keys=("q", "k", "v", "out", "gate", "up", "down",
                                "fc1", "fc2", "lm_head"), bits: int = 8,
                  group: int = GROUP4):
    """Quantize every matching {"w": ...} projection dict of a parameter
    tree (dicts and lists; 2-D weights or layer-stacked 3-D). bits=4 uses
    grouped int4 and keeps the lm_head int8; the group shrinks to fit a
    small K, and a projection falls back to int8 when no group ≥ 8 fits."""
    def quant(w, name):
        if bits == 4 and name != "lm_head":
            k = w.shape[-2]
            g = min(group, k // 2)
            while g >= 8 and k % (2 * g):
                g //= 2
            if g >= 8:
                return quantize_int4(w, group=g)
        return quantize_int8(w)

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if isinstance(node, dict):
            if "w" in node and name in keys and node["w"].ndim in (2, 3):
                q = quant(node["w"], name)
                if "b" in node:
                    q["b"] = node["b"]
                return q
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)


def quant_act_grouped(x: torch.Tensor, n_groups: int):
    """(M, K) float → (xq int8 (M, K), xs f32 (M, n_groups)): symmetric
    int8 per (row, group of K / n_groups)."""
    m, k = x.shape
    xf = x.float().reshape(m, n_groups, k // n_groups)
    xs = _div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12), 127.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq.reshape(m, k), xs[..., 0]


def w4a8_groups(holder: dict, names: tuple, m: int) -> int:
    """The group count of `holder`'s projections `names` where all of them
    are int4 of one group count and m ≤ W4A8_MAX_M: they then share one
    quantized input (xq, xs), which `matmul_any` takes as `act`. 0 where
    they take x itself (more rows, another weight format, or unequal
    groups)."""
    kinds = {holder[n]["scale4"].shape[-2] if "w_q4" in holder[n] else 0 for n in names}
    return kinds.pop() if m <= W4A8_MAX_M and len(kinds) == 1 else 0


def join_int4(holder: dict, siblings: dict) -> None:
    """Joins `holder`'s sibling projections in place along N: for each
    fused name → sibling names of `siblings`, where all the siblings are
    int4 {"w_q4", "scale4"} of one K and one group count (2-D projections
    or 3-D expert stacks), the holder gets {"w_q4", "scale4"}, their
    columns side by side in the siblings' order, under the fused name and
    loses the separate ones. Others keep theirs."""
    for fused, names in siblings.items():
        parts = [holder.get(n) for n in names]
        if not all(p is not None and set(p) == {"w_q4", "scale4"} for p in parts):
            continue
        if len({(p["w_q4"].shape[:-1], p["scale4"].shape[:-1]) for p in parts}) != 1:
            continue
        holder[fused] = {key: torch.cat([p[key] for p in parts], dim=-1)
                         for key in ("w_q4", "scale4")}
        for n in names:
            del holder[n]


# ---------------------------------------------------------------------------
# Plain versions


def _unpack_int4(w_q4: torch.Tensor):
    """packed (K/2, N) int8 → (lo, hi) int32 (K/2, N), sign-extended."""
    w32 = w_q4.to(torch.int32)
    return (w32 << 28) >> 28, w32 >> 4


def _scale_halves(lo: torch.Tensor, hi: torch.Tensor, scale: torch.Tensor, k: int):
    """(lo, hi) nibbles (K/2, N) + scale (K/G, N) → (lo, hi) bf16 (K/2, N):
    nibble × its group's f32 scale in f32, rounded once to bf16."""
    n_groups = scale.shape[-2]
    g = k // n_groups
    half = n_groups // 2

    def scale_half(x, s):
        xg = x.reshape(half, g, -1).float()
        return (xg * s[:, None, :]).reshape(k // 2, -1).to(torch.bfloat16)

    return scale_half(lo, scale[:half]), scale_half(hi, scale[half:])


def _dequant4_halves(w_q4: torch.Tensor, scale: torch.Tensor, k: int):
    """packed (K/2, N) int8 + scale (K/G, N) → (lo, hi) bf16 (K/2, N)."""
    return _scale_halves(*_unpack_int4(w_q4), scale, k)


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math (_q_matmul_kernel): W = bf16(w_q) ·
    bf16(scale) rounded to bf16, bf16(x) @ W with f32 sums, one rounding
    to x's dtype."""
    w = w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    return (x.to(torch.bfloat16).float() @ w.float()).to(x.dtype)


def _int8_matmul_xla(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's dequant matmul for m ≤ 8 (plain XLA there, plain
    torch here): W as int8_matmul's, the product rounded to bf16, then to
    x's dtype."""
    w = w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    return (x.to(torch.bfloat16) @ w).to(x.dtype)


def _int4_from_halves(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """int4_matmul's math over the given (lo, hi) nibbles: both halves
    dequantized by _scale_halves, x_lo @ lo + x_hi @ hi in f32 over
    bf16(x), one rounding to x's dtype."""
    k = x.shape[-1]
    lo, hi = _scale_halves(lo, hi, scale, k)
    xb = x.to(torch.bfloat16).float()
    acc = xb[:, : k // 2] @ lo.float()
    acc += xb[:, k // 2:] @ hi.float()
    return acc.to(x.dtype)


def int4_matmul_reference(x: torch.Tensor, w_q4: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math (_q4_matmul_kernel), see _int4_from_halves."""
    return _int4_from_halves(x, *_unpack_int4(w_q4), scale)


def _int4_matmul_xla(x: torch.Tensor, w_q4: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's plain twin of int4_matmul: the same sums, but
    the result rounded to bf16 whatever x's dtype."""
    return int4_matmul_reference(x.to(torch.bfloat16), w_q4, scale)


def _s8_from_halves(xq: torch.Tensor, xs: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """int4_matmul_s8's math over the given (lo, hi) nibbles: per group g
    an exact integer dot of xq and the nibbles, then, groups in order,
    acc += dot · (xs[:, g] · ws[g]) in f32; bf16 out. The dots run as f32
    products, exact because every partial sum is an integer below 2^24
    (|xq·w| ≤ 127·15 over at most 8800 terms a group)."""
    m, k = xq.shape
    n_groups = scale4.shape[0]
    g = k // n_groups
    w = torch.cat([lo, hi]).float().reshape(n_groups, g, -1)          # (ng, g, N)
    x = xq.float().reshape(m, n_groups, g).transpose(0, 1)            # (ng, M, g)
    dots = torch.bmm(x, w)                                            # (ng, M, N)
    acc = torch.zeros(m, w.shape[-1], dtype=torch.float32, device=xq.device)
    for gi in range(n_groups):
        acc += dots[gi] * (xs[:, gi:gi + 1] * scale4[gi:gi + 1])
    return acc.to(torch.bfloat16)


def int4_matmul_s8_reference(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                             scale4: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math (_s8g4_kernel) over the sign-extended
    nibbles, see _s8_from_halves."""
    return _s8_from_halves(xq, xs, *_unpack_int4(w_q4), scale4)


def int4_group_matmul_reference(x: torch.Tensor, w_q4: torch.Tensor, scale4: torch.Tensor,
                                counts: list[int], split: bool = False):
    """int4_matmul_reference of each expert e over its counts[e] rows of
    x (R, K), the rows grouped by expert in order, against w_q4 (E, K/2,
    N), scale4 (E, K/G, N); (R, N) in x's dtype, or with split its two
    column halves."""
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(int4_matmul_reference(x[start:start + n], w_q4[e], scale4[e]))
            start += n
    out = torch.cat(outs)
    return tuple(out.chunk(2, dim=-1)) if split else out


def int4_moe_s8_reference(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                          scale4: torch.Tensor, ids: torch.Tensor, x_div: int = 1,
                          split: bool = False):
    """Row r: int4_matmul_s8_reference of xq row r // x_div against expert
    ids[r] (clamped into the stack) of w_q4 (E, K/2, N), scale4 (E, K/G,
    N); (R, N) bf16, or with split its two column halves, each (R, N/2)."""
    rows = ids.clamp(0, w_q4.shape[0] - 1).tolist()
    out = torch.cat([int4_matmul_s8_reference(xq[r // x_div:r // x_div + 1],
                                              xs[r // x_div:r // x_div + 1], w_q4[e], scale4[e])
                     for r, e in enumerate(rows)])
    return tuple(out.chunk(2, dim=-1)) if split else out


# ---------------------------------------------------------------------------
# Kernel wrappers


# the wgmma ring's tile and K split (csrc/wgmma_ring.cuh), int4_matmul's
# plan (csrc/int4_matmul.cu:make_plan) and int8_matmul's above its GEMV rows
INT4_BLOCK = (256, 128)     # output rows × columns a block (or cluster) computes
INT4_CHUNK = 32             # packed rows a pipeline stage holds
INT4_SMS = 132              # the H100's SMs: fewer tiles than this split K
INT4_MAX_SPLIT = 4


# int8_matmul's plan mirrors csrc/int8_matmul.cu:make_plan: the split-K
# GEMV of csrc/gemv_mma.cuh at decode rows, the wgmma ring of
# csrc/wgmma_ring.cuh (int4_matmul's tile and K split) above
INT8_GEMV_MAX_M = 8         # rows the GEMV takes: one n8 tile of x
INT8_GEMV_STEP = 16         # K rows a GEMV step (the mma's depth)
INT8_CHUNK = 64             # K rows a ring chunk
GEMV_COLS = 128             # columns a GEMV block owns
GEMV_WARPS = 8              # warps of a GEMV block, each taking every 8th step
GEMV_MAX_SPLIT = 8          # the portable cluster size
GEMV_BLOCKS = 264           # blocks a GEMV split aims for: two an SM on 132


def gemv_split(steps: int, n: int) -> int:
    """The GEMV's K split (csrc/gemv_mma.cuh:gemv_split): the cluster
    size, doubled (to at most 8) while tiles × split stays within
    GEMV_BLOCKS and every warp of every rank keeps a step of K."""
    tiles = -(-n // GEMV_COLS)
    split = 1
    while (split < GEMV_MAX_SPLIT and 2 * tiles * split <= GEMV_BLOCKS
           and 2 * split * GEMV_WARPS <= steps):
        split *= 2
    return split


def split_ranges(steps: int, split: int) -> list[range]:
    """The K steps (or chunks) each rank of a split takes: rank r holds
    [r·steps/split, (r+1)·steps/split), as the kernels cut them."""
    return [range(r * steps // split, (r + 1) * steps // split) for r in range(split)]


def int8_plan(m: int, k: int, n: int) -> tuple[str, int]:
    """int8_matmul's regime and K split: ("gemv", split) for M ≤
    INT8_GEMV_MAX_M (split over K steps of INT8_GEMV_STEP rows),
    ("wgmma", split) above (int4_matmul's split over chunks of
    INT8_CHUNK rows)."""
    if m <= INT8_GEMV_MAX_M:
        return "gemv", gemv_split(-(-k // INT8_GEMV_STEP), n)
    return "wgmma", _ring_split(m, n, -(-k // INT8_CHUNK))


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(w_q (K, N) int8, scale (N,) f32) → (M, N) in
    x's dtype.

    CUDA: csrc/int8_matmul.cu, the regime `int8_plan` names; bf16 x,
    16-byte aligned, K a multiple of 8, N of 4; ragged M, N and K are
    masked in the kernel (no padded copy of W). CPU: the plain version."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    _check_cuda("int8_matmul", {"x": x, "w_q": w_q, "scale": scale},
                {"x": torch.bfloat16, "w_q": torch.int8, "scale": torch.float32},
                align={"x": 16, "w_q": 4, "scale": 4})
    m, k = x.shape
    n = w_q.shape[-1]
    if w_q.shape != (k, n) or scale.shape != (n,):
        raise ValueError(f"int8_matmul: expected x (M, K), w_q (K, N), scale (N,); "
                         f"got {x.shape}, {w_q.shape}, {scale.shape}")
    if m < 1 or k < 8 or k % 8 or n < 4 or n % 4 or -(-n // INT4_BLOCK[1]) > 65535:
        raise ValueError(f"int8_matmul: M={m}, K={k} (multiple of 8) and N={n} "
                         f"(multiple of 4, at most 8388480) out of range")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    build.launch("int8_matmul", x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, k, n, _stream(x.device))
    count_launch(launch_counts, "int8_matmul")
    return out


def _check_int4(name: str, k: int, w_q4: torch.Tensor, scale: torch.Tensor) -> int:
    n = w_q4.shape[-1]
    n_groups = scale.shape[0]
    if w_q4.shape != (k // 2, n) or scale.shape != (n_groups, n):
        raise ValueError(f"{name}: expected w_q4 (K/2, N) and scale (K/G, N) for "
                         f"K={k}; got {w_q4.shape}, {scale.shape}")
    if k % 16 or n % 4 or n_groups < 2 or n_groups % 2 or k % n_groups:
        raise ValueError(f"{name}: K={k} (multiple of 16), N={n} (multiple of 4) "
                         f"and {n_groups} groups (even, dividing K) out of range")
    return n


def _ring_split(m: int, n: int, chunks: int) -> int:
    """The wgmma ring's K split (csrc/wgmma_ring.cuh:ring_split): the
    size of the thread-block cluster that shares one output tile. 1 when
    the tiles alone fill the card; else doubled (to at most 4, and at most
    half the chunks) until tiles × split ≥ INT4_SMS."""
    tiles = -(-m // INT4_BLOCK[0]) * -(-n // INT4_BLOCK[1])
    split = 1
    while tiles * split < INT4_SMS and split < INT4_MAX_SPLIT and 2 * split <= chunks:
        split *= 2
    return split


def int4_plan(m: int, k: int, n: int) -> int:
    """int4_matmul's K split over chunks of INT4_CHUNK packed rows, see
    _ring_split."""
    return _ring_split(m, n, -(-(k // 2) // INT4_CHUNK))


def int4_matmul(x: torch.Tensor, w_q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant4(w_q4 (K/2, N) packed, scale (K/G, N) f32) →
    (M, N) in x's dtype.

    CUDA: csrc/int4_matmul.cu (wgmma over dequantized tiles, K split
    over a cluster where `int4_plan` says so); bf16 x, 16-byte aligned.
    CPU: the plain version."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, w_q4, scale)
    _check_cuda("int4_matmul", {"x": x, "w_q4": w_q4, "scale": scale},
                {"x": torch.bfloat16, "w_q4": torch.int8, "scale": torch.float32},
                align={"x": 16, "w_q4": 4, "scale": 16})
    m, k = x.shape
    n = _check_int4("int4_matmul", k, w_q4, scale)
    if m < 1 or -(-n // INT4_BLOCK[1]) > 65535:
        raise ValueError(f"int4_matmul: M={m} or N={n} out of range")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    build.launch("int4_matmul", x.data_ptr(), w_q4.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, k, n, scale.shape[0], _stream(x.device))
    count_launch(launch_counts, "int4_matmul")
    return out


# int4_matmul_s8's plan mirrors csrc/int4_s8.cuh: its column tile (16-byte
# loads, or 4-byte), its warps a block, its shared memory and the ranks
# of a split of K
S8_BLOCK_N = (128, 32)
S8_WARPS = 8
S8_FILL_BLOCKS = 96         # column tiles that fill the card without a split of K
S8_WHOLE_SMEM = 200 * 1024  # shared memory a block may take to hold every group
S8_MAX_SMEM = 232448 - 1024  # the most a block may take (csrc MAX_SMEM)
S8_MAX_CLUSTER = 8          # ranks of a split: the portable cluster size
# blocks the H100 holds at once in clusters of 2 to 8 at one row of M (two
# an SM; cudaOccupancyMaxActiveClusters: 224 in clusters of 7, up to 264
# in clusters of 2)
S8_WAVE_BLOCKS = 224


def s8_fold_cols(bn: int, splits: int) -> int:
    """The columns of a bn-column tile each rank of a split folds
    (csrc/int4_s8.cuh:fold_cols): rank r takes [r·cols, (r+1)·cols),
    whole groups of 4 (the last rank fewer, or none)."""
    return 4 * -(-(bn // 4) // splits)


def s8_layout_bytes(mt: int, pb: int, group: int, bn: int, n_groups: int,
                    splits: int) -> int:
    """A block's shared memory (csrc/int4_s8.cuh:Layout): xq bytes, xs,
    ws rows and the terms of its pb pairs, and with a split the terms of
    the columns it folds, from every group."""
    def align16(x):
        return (x + 15) & ~15

    cols = s8_fold_cols(bn, splits)
    terms = align16(align16(mt * 2 * pb * group) + mt * 2 * pb * 4) + 2 * pb * bn * 4
    return terms + 2 * pb * mt * bn * 4 + (n_groups * mt * cols * 4 if splits > 1 else 0)


def s8_pairs_per_block(m: int, k: int, n: int, n_groups: int, wide: bool,
                       rows_per_block: int = 8) -> int:
    """int4_matmul_s8's plan: the group pairs each block takes. All of
    them (n_groups / 2: no split, the fold stays in shared memory) when
    the column tiles alone fill the card and the block's xq bytes and
    terms fit. Else K is split over a cluster of at most S8_MAX_CLUSTER
    blocks: the fewest pairs a block (2, 4, 8, then multiples of 8, so
    that its 8 warps share them evenly, at most 4 warps a pair) whose
    grid the card holds in one wave (S8_WAVE_BLOCKS at one row of M; half
    as many above, one block an SM) and whose shared memory fits; where
    no such grid fits a wave, the most pairs that fit. A block takes
    rows_per_block rows of M: 8, or 1 for int4_moe_s8."""
    half = n_groups // 2
    bn = S8_BLOCK_N[0] if wide else S8_BLOCK_N[1]
    blocks = -(-n // bn) * -(-m // rows_per_block)
    mt = min(m, rows_per_block)
    group = k // n_groups
    if blocks >= S8_FILL_BLOCKS and s8_layout_bytes(mt, half, group, bn, n_groups,
                                                    1) <= S8_WHOLE_SMEM:
        return half
    wave = S8_WAVE_BLOCKS if mt == 1 else S8_WAVE_BLOCKS // 2
    most, pb = half, 2
    while pb < half:
        splits = -(-half // pb)
        if (splits <= S8_MAX_CLUSTER and
                s8_layout_bytes(mt, pb, group, bn, n_groups, splits) <= S8_MAX_SMEM):
            if blocks * splits <= wave:
                return pb
            most = pb
        pb = 2 * pb if pb < S8_WARPS else pb + S8_WARPS
    return most


def s8_resident_clusters(m: int, k: int, n: int, n_groups: int, pb: int) -> int:
    """The clusters of int4_matmul_s8's launch at pb pairs a block that
    the card holds at once (cudaOccupancyMaxActiveClusters, asked of the
    built kernel: the card's machine only); -1 where pb splits no K."""
    entry = build.library("int4_matmul_s8").tww_int4_matmul_s8_clusters
    entry.argtypes = [ctypes.c_int] * 5
    entry.restype = ctypes.c_int
    count = entry(m, k, n, n_groups, pb)
    if count < -1:
        raise ValueError(f"int4_matmul_s8 takes no launch of {pb} pairs a block at "
                         f"M={m}, K={k}, N={n}, {n_groups} groups")
    return count


def s8_cluster_launch(name: str) -> None:
    """Count one launch of kernel `name` (int4_matmul_s8 or int4_moe_s8)
    that splits K over a thread-block cluster, as count_launch counts;
    the wrappers call it beside such a launch, so a profiler that wraps
    it sees each."""
    count_launch(cluster_launch_counts, f"{name}.cluster")


def _check_int4_s8(xq, xs, w_q4, scale4) -> tuple[int, int, int, int]:
    """int4_matmul_s8's shape checks → (M, K, N, n_groups). The kernel
    also needs G a multiple of 4: a lane's 4-row dp4a stays in one group."""
    m, k = xq.shape
    n = _check_int4("int4_matmul_s8", k, w_q4, scale4)
    n_groups = scale4.shape[0]
    if xs.shape != (m, n_groups):
        raise ValueError(f"int4_matmul_s8: xs must be (M, K/G) = {(m, n_groups)}, "
                         f"got {xs.shape}")
    if (k // n_groups) % 4:
        raise ValueError(f"int4_matmul_s8: the group size {k // n_groups} must be a "
                         f"multiple of 4")
    if not 1 <= m <= 65535 or n_groups // 2 > 65535:
        raise ValueError(f"int4_matmul_s8: M={m} or {n_groups} groups out of range")
    return m, k, n, n_groups


def int4_matmul_s8(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                   scale4: torch.Tensor) -> torch.Tensor:
    """W4A8: xq (M, K) int8 with xs (M, K/G) f32 against w_q4 (K/2, N)
    packed and scale4 (K/G, N) f32 → (M, N) bf16. Any M: rows go in
    chunks of 8 across the grid.

    CUDA: csrc/int4_matmul_s8.cu, one launch; G a multiple of 4, xq
    4-byte and scale4 16-byte aligned. Where `s8_pairs_per_block`
    splits K, the split is one thread-block cluster a column tile, which
    folds through distributed shared memory (`s8_cluster_launch` counts
    it). CPU: the plain version."""
    if xq.device.type == "cpu":
        return int4_matmul_s8_reference(xq, xs, w_q4, scale4)
    _check_cuda("int4_matmul_s8", {"xq": xq, "xs": xs, "w_q4": w_q4, "scale4": scale4},
                {"xq": torch.int8, "xs": torch.float32, "w_q4": torch.int8,
                 "scale4": torch.float32}, align={"xq": 4, "xs": 4, "w_q4": 4, "scale4": 16})
    m, k, n, n_groups = _check_int4_s8(xq, xs, w_q4, scale4)
    wide = n % 16 == 0 and w_q4.data_ptr() % 16 == 0
    pb = s8_pairs_per_block(m, k, n, n_groups, wide)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    build.launch("int4_matmul_s8", xq.data_ptr(), xs.data_ptr(), w_q4.data_ptr(),
                 scale4.data_ptr(), out.data_ptr(), m, k, n, n_groups, pb, _stream(xq.device))
    count_launch(launch_counts, "int4_matmul_s8")
    if pb < n_groups // 2:
        s8_cluster_launch("int4_matmul_s8")
    return out


def int4_moe_s8(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor, scale4: torch.Tensor,
                ids: torch.Tensor, x_div: int = 1, split: bool = False):
    """The experts' W4A8 product: output row r is xq row r // x_div (with
    its xs row) against expert ids[r] of w_q4 (E, K/2, N) packed and
    scale4 (E, K/G, N) f32, as int4_matmul_s8 computes it; ids (R,) int64
    on the device, never read by the host (an id outside [0, E) reads the
    nearest expert). → (R, N) bf16; with split, gate and up apart: the
    two column halves as dense (R, N/2) tensors.

    CUDA: csrc/int4_moe_s8.cu, one launch, one output row a block, the
    plan s8_pairs_per_block(rows_per_block=1), int4_matmul_s8's cluster
    fold where it splits K. CPU: the plain version (which reads the
    ids)."""
    if xq.device.type == "cpu":
        return int4_moe_s8_reference(xq, xs, w_q4, scale4, ids, x_div, split)
    _check_cuda("int4_moe_s8", {"xq": xq, "xs": xs, "w_q4": w_q4, "scale4": scale4, "ids": ids},
                {"xq": torch.int8, "xs": torch.float32, "w_q4": torch.int8,
                 "scale4": torch.float32, "ids": torch.int64},
                align={"xq": 4, "xs": 4, "w_q4": 4, "scale4": 16, "ids": 8})
    rows = ids.shape[0]
    if (ids.dim() != 1 or w_q4.dim() != 3 or scale4.dim() != 3 or x_div < 1
            or xq.shape[0] * x_div != rows or w_q4.shape[0] != scale4.shape[0]):
        raise ValueError(f"int4_moe_s8: ids {tuple(ids.shape)}, xq {tuple(xq.shape)}, x_div "
                         f"{x_div}, w_q4 {tuple(w_q4.shape)}, scale4 {tuple(scale4.shape)}")
    _, k, n, n_groups = _check_int4_s8(xq, xs, w_q4[0], scale4[0])
    if split and n % 8:
        raise ValueError(f"int4_moe_s8: N={n} has no halves of a multiple of 4")
    wide = n % 16 == 0 and w_q4.data_ptr() % 16 == 0
    pb = s8_pairs_per_block(rows, k, n, n_groups, wide, rows_per_block=1)
    out = torch.empty((2, rows, n // 2) if split else (rows, n), dtype=torch.bfloat16,
                      device=xq.device)
    build.launch("int4_moe_s8", xq.data_ptr(), xs.data_ptr(), w_q4.data_ptr(),
                 scale4.data_ptr(), ids.data_ptr(), out.data_ptr(), rows, x_div, k, n,
                 n_groups, pb, n // 2 if split else 0, w_q4.shape[0], _stream(xq.device))
    count_launch(launch_counts, "int4_moe_s8")
    if pb < n_groups // 2:
        s8_cluster_launch("int4_moe_s8")
    return (out[0], out[1]) if split else out


GROUP_ROWS = 64             # csrc/int4_group_matmul.cu's rows a tile


def group_tiles(counts: list[int]) -> list[tuple[int, int, int]]:
    """int4_group_matmul's tile table: (expert, first row, rows) for each
    block row, the experts' rows cut in tiles of at most GROUP_ROWS."""
    tiles, start = [], 0
    for e, n in enumerate(counts):
        tiles += [(e, start + r, min(GROUP_ROWS, n - r)) for r in range(0, n, GROUP_ROWS)]
        start += n
    return tiles


def int4_group_matmul(x: torch.Tensor, w_q4: torch.Tensor, scale4: torch.Tensor,
                      counts: list[int], split: bool = False):
    """int4_matmul of every expert over its rows in one launch: x (R, K)
    holds the rows grouped by expert, counts[e] of them for expert e (a
    host list: the caller has read it), against the stacked w_q4 (E, K/2,
    N) packed and scale4 (E, K/G, N) f32 → (R, N) bf16; with split, gate
    and up apart: the two column halves as dense (R, N/2) tensors.

    CUDA: csrc/int4_group_matmul.cu, a block a tile of `group_tiles`
    and 128 columns; bf16 x, K a multiple of 64 with groups of a multiple
    of 32 rows, N of 16, the weights 16-byte aligned. CPU: the plain
    version."""
    if x.device.type == "cpu":
        return int4_group_matmul_reference(x, w_q4, scale4, counts, split)
    _check_cuda("int4_group_matmul", {"x": x, "w_q4": w_q4, "scale4": scale4},
                {"x": torch.bfloat16, "w_q4": torch.int8, "scale4": torch.float32}, align=16)
    r, k = x.shape
    n, n_groups = w_q4.shape[-1], scale4.shape[-2]
    if (w_q4.dim() != 3 or w_q4.shape[1:] != (k // 2, n) or scale4.shape != (w_q4.shape[0],
                                                                            n_groups, n)
            or len(counts) != w_q4.shape[0] or sum(counts) != r or k % 64 or k % n_groups
            or (k // n_groups) % 32 or n % 16 or (split and n % 4)):
        raise ValueError(f"int4_group_matmul: x {tuple(x.shape)}, w_q4 {tuple(w_q4.shape)}, "
                         f"scale4 {tuple(scale4.shape)}, {len(counts)} counts of {sum(counts)}")
    tiles = torch.tensor(group_tiles(counts), dtype=torch.int32).to(x.device, non_blocking=True)
    out = torch.empty((2, r, n // 2) if split else (r, n), dtype=torch.bfloat16, device=x.device)
    build.launch("int4_group_matmul", x.data_ptr(), w_q4.data_ptr(), scale4.data_ptr(),
                 tiles.data_ptr(), out.data_ptr(), tiles.shape[0], r, k, n, n_groups,
                 n // 2 if split else 0, _stream(x.device))
    count_launch(launch_counts, "int4_group_matmul")
    return (out[0], out[1]) if split else out


# ---------------------------------------------------------------------------
# Routing


def matmul_any(x: torch.Tensor, wp: dict, act: tuple | None = None) -> torch.Tensor:
    """x (..., K) @ w for a dense {"w"}, int8 {"w_q", "scale"} or int4
    {"w_q4", "scale4"} param dict, with the JAX package's TPU route by
    the row count m after the leading dims are flattened:

    * int4: m ≤ W4A8_MAX_M → quant_act_grouped + int4_matmul_s8 (or
      `act`, x's (xq, xs) already quantized, as the Llama layer's kernels
      give it for the projections that share x, `w4a8_groups`: XLA's CSE
      gives the JAX program one quantization for q, k and v, and one for
      gate and up); above → int4_matmul;
    * int8: m ≤ INT8_GEMV_MAX_M → the dequant matmul (plain torch, as XLA
      computes it in the JAX package) on the CPU, and on the card
      int8_matmul, whose GEMV regime computes the same function (W
      rounded to bf16 per element, f32 sums, bf16 out) without the
      dequantized copy of W; above → int8_matmul;
    * dense: x @ w.

    On the CPU each kernel's plain version takes its place. The wrappers
    are looked up as module attributes at call time, so a caller may
    swap them."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    xf = x.reshape(-1, k).contiguous()      # the kernels take dense rows
    m = xf.shape[0]
    if act is not None and ("w_q4" not in wp or m > W4A8_MAX_M or act[1].shape != (
            m, wp["scale4"].shape[0])):
        raise ValueError(f"matmul_any: a quantized input is for an int4 weight at m <= "
                         f"{W4A8_MAX_M}, in its groups")
    if "w_q4" in wp:
        if m <= W4A8_MAX_M:
            xq, xs = act if act is not None else quant_act_grouped(xf, wp["scale4"].shape[0])
            out = int4_matmul_s8(xq, xs, wp["w_q4"], wp["scale4"]).to(x.dtype)
        else:
            out = int4_matmul(xf, wp["w_q4"], wp["scale4"])
        return out.reshape(*lead, -1)
    if "w_q" not in wp:
        return x @ wp["w"].to(x.dtype)
    if m > INT8_GEMV_MAX_M:
        out = int8_matmul(xf, wp["w_q"], wp["scale"])
    elif xf.device.type == "cuda":
        out = int8_matmul(xf.to(torch.bfloat16), wp["w_q"], wp["scale"]).to(x.dtype)
    else:
        out = _int8_matmul_xla(xf, wp["w_q"], wp["scale"])
    return out.reshape(*lead, -1)
