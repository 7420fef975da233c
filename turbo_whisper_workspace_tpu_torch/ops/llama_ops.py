"""The Llama layer's work beside its projections, as CUDA kernels.

The JAX package has no module of this name. It runs the Llama forward as
one jit-compiled XLA program (turbo_whisper_workspace_tpu/models/
llama.py:139-175, `lax.scan` over the layers), in which XLA fuses what
this module's four kernels compute:

* `llama_attention`: GQA attention over the bf16 cache, the two einsums
  with the position mask and the f32 softmax (models/llama.py:156-168);
  csrc/llama_attention.cu. The Whisper decoder's self-attention over its
  bf16 cache (turbo_whisper_workspace_tpu/models/whisper.py:602-613,
  `mha` under the key ≤ position mask) is the same function at group 1
  and head dim 64: models/whisper.py calls it there too;
* `llama_norm_quant`: the residual add, rms_norm (:89-92) and
  ops/quant.py:222 `quant_act_grouped`, which XLA computes once for the
  input q, k and v share and once for gate and up's; without the norm
  it quantizes the attention output for the out projection;
  csrc/llama_norm_quant.cu;
* `llama_rope_cache`: _rope (:95-108) of q and k and the cache's
  dynamic_update_slice (:148-155); csrc/llama_rope_cache.cu;
* `llama_swiglu_quant`: silu(gate) · up (:172-174) and the quantizer of
  the down projection's input; csrc/llama_swiglu_quant.cu.

Each has a wrapper and a plain PyTorch version beside it, the port's
`models/llama.py` arithmetic as it was before the kernels (so `forward`
on the CPU is unchanged). For CUDA tensors a wrapper checks them,
allocates its outputs, launches its kernel on the current stream and
counts the launch in `launch_counts`; for CPU tensors it runs the plain
version; anything else raises. The kernels take bf16. `pos` is a host
int or a 0-dim int64 tensor on the tensors' device, which the kernels
read from device memory (a decode step a CUDA graph replays).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .build import _check_cuda, _stream, count_launch
from .quant import quant_act_grouped

# kernel name → launches since the last reset_launch_counts()
launch_counts = {name: 0 for name in ("llama_attention", "llama_norm_quant",
                                      "llama_rope_cache", "llama_swiglu_quant")}

# llama_attention's plan, mirrored from csrc/llama_attention.cu:make_plan
DECODE_MAX_T = 8            # query rows a decode-regime step takes
DECODE_MAX_ROWS = 32        # query rows a kv head (group · t) it takes
KEYS_PER_RANK = 64          # a rank's slice of the cache before the ranks are capped
MAX_RANKS = 8               # the portable cluster size
WAVE_BLOCKS = 264           # decode blocks in flight: two an SM of the H100's 132
HEAD_DIMS = (16, 32, 64, 128)   # the kernel's head dims: the Llama configs' 128, test-tiny's
                                # 16, a 2048-wide 32-head checkpoint's 64 (and Whisper's)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def attention_plan(t: int, group: int, s_len: int, pairs: int) -> tuple:
    """llama_attention's regime: ("decode", rows, ranks, slice) for t ≤
    DECODE_MAX_T and group · t ≤ DECODE_MAX_ROWS (one cluster of `ranks`
    blocks a (b, kv head), `pairs` = batch · n_kv of them, rows padded to
    4, 8 or 32, at most `slice` keys a rank: the launch depends on the
    cache length and the pairs only; ranks at most WAVE_BLOCKS // pairs),
    else ("prefill", q_tiles) (blocks of 64 query rows a head). The
    kernel's own plan is kernel_plan's."""
    if t <= DECODE_MAX_T and group * t <= DECODE_MAX_ROWS:
        ranks = min(MAX_RANKS, max(1, -(-s_len // KEYS_PER_RANK)),
                    max(1, WAVE_BLOCKS // max(pairs, 1)))
        rows = next(r for r in (4, 8, 32) if group * t <= r)
        return "decode", rows, ranks, -(-s_len // ranks)
    return "prefill", -(-t // 64)


def kernel_plan(t: int, group: int, s_len: int, pairs: int) -> tuple:
    """The plan csrc/llama_attention.cu launches for these arguments, in
    attention_plan's form, read from the built library (the card's
    machine): the check that the mirror is the kernel's plan."""
    entry = build.library("llama_attention").tww_llama_attention_plan
    entry.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    entry.restype = None
    out = (ctypes.c_int * 4)()
    entry(t, group, s_len, pairs, ctypes.cast(out, ctypes.c_void_p))
    return ("decode", *out[1:]) if out[0] else ("prefill", out[1])


def decode_slices(pos: int, t: int, ranks: int) -> list[range]:
    """The keys each rank of a decode-regime cluster reads: the pos + t
    visible keys cut in `ranks` equal slices (the last ones empty only at
    the first few positions)."""
    n = pos + t
    slice_ = -(-n // ranks)
    return [range(min(r * slice_, n), min((r + 1) * slice_, n)) for r in range(ranks)]


# ---------------------------------------------------------------------------
# Plain versions


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics, then bf16 (x's dtype) × scale."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * scale.to(x.dtype)


def llama_norm_quant_reference(x: torch.Tensor, scale: torch.Tensor | None, eps: float,
                               delta: torch.Tensor | None = None, n_groups: int = 0,
                               norm: bool = True):
    """(x', h, act): x' = x + delta (x when delta is None), h =
    rms_norm(x') (x' itself when norm is False), act = quant_act_grouped
    of h's rows in n_groups groups, or None when n_groups is 0."""
    if delta is not None:
        x = x + delta
    h = rms_norm_reference(x, scale, eps) if norm else x
    act = quant_act_grouped(h.reshape(-1, h.shape[-1]), n_groups) if n_groups else None
    return x, h, act


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The half-split rotation of x (B, T, H, Dh) by (1, T, 1, Dh/2) f32
    tables: f32 products and sums, one rounding to x's dtype."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _positions(pos, t: int, device) -> torch.Tensor:
    return pos + torch.arange(t, device=device)


def llama_rope_cache_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               ck: torch.Tensor, cv: torch.Tensor, cos: torch.Tensor,
                               sin: torch.Tensor, pos) -> torch.Tensor:
    """q (B, t, H, Dh) rotated → returned; k rotated and v written into
    cache rows pos..pos+t-1 of ck, cv (B, S, kvh·Dh), in place. cos, sin:
    (max_ctx, Dh/2) f32 tables (models/llama.py:rope_table)."""
    b, t = q.shape[:2]
    positions = _positions(pos, t, q.device)
    rows = tuple(tab.index_select(0, positions)[None, :, None, :] for tab in (cos, sin))
    q = apply_rope(q, *rows)
    k = apply_rope(k, *rows)
    ck.index_copy_(1, positions, k.reshape(b, t, -1).to(ck.dtype))
    cv.index_copy_(1, positions, v.reshape(b, t, -1).to(cv.dtype))
    return q


def llama_attention_reference(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                              pos) -> torch.Tensor:
    """q (B, t, H, Dh) at positions pos..pos+t-1 over the whole cache
    ck, cv (B, S, kvh·Dh) under the mask key ≤ position → (B, t, H·Dh) in
    q's dtype. GQA: query head i reads kv head i // group. f32 scores
    scaled by Dh^-1/2, f32 softmax, weights rounded to q's dtype before
    P·V."""
    b, t, h, dh = q.shape
    s_len = ck.shape[1]
    kvh = ck.shape[-1] // dh
    mask = (torch.arange(s_len, device=q.device)[None, :]
            <= _positions(pos, t, q.device)[:, None])                   # (t, S)
    kk = ck.reshape(b, s_len, kvh, dh).to(q.dtype)
    vv = cv.reshape(b, s_len, kvh, dh).to(q.dtype)
    q5 = q.reshape(b, t, kvh, h // kvh, dh)
    logits = torch.einsum("btkgd,bskd->bkgts", q5.float(), kk.float()) * dh ** -0.5
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskd->btkgd", w, vv).reshape(b, t, h * dh)


def llama_swiglu_quant_reference(gate: torch.Tensor, up: torch.Tensor, n_groups: int = 0):
    """(p, act): p = silu(gate) · up in gate's dtype (each product
    rounded), act = quant_act_grouped of p's rows, or None when
    n_groups is 0."""
    p = gate * torch.sigmoid(gate) * up
    act = quant_act_grouped(p.reshape(-1, p.shape[-1]), n_groups) if n_groups else None
    return p, act


# ---------------------------------------------------------------------------
# Kernel wrappers


def _device_pos(pos, t: int, s_len: int, device) -> tuple:
    """(pointer, host int) of the kernels' pos: a 0-dim int64 tensor on
    the device is read there (clamped to [0, S − t]); a host int must lie
    in that range."""
    if torch.is_tensor(pos):
        if pos.device != device or pos.dtype != torch.int64 or pos.numel() != 1:
            raise ValueError(f"pos must be one int64 on {device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        return pos.data_ptr(), 0
    if not 0 <= pos <= s_len - t:
        raise ValueError(f"pos {pos} + t {t} outside the cache of {s_len}")
    return None, int(pos)


def llama_norm_quant(x: torch.Tensor, scale: torch.Tensor | None, eps: float,
                     delta: torch.Tensor | None = None, n_groups: int = 0,
                     norm: bool = True):
    """See llama_norm_quant_reference; x (..., d) and delta bf16.

    CUDA: csrc/llama_norm_quant.cu, one launch: mode 2 (the residual add
    and the norm) with delta, mode 1 (the norm) without, mode 0 (norm
    False: only the quantizer, which n_groups must then ask for). d a
    multiple of 8 up to 16384; the group d / n_groups a multiple of 8
    whose eighth divides 32. CPU: the plain version."""
    if x.device.type == "cpu":
        return llama_norm_quant_reference(x, scale, eps, delta, n_groups, norm)
    tensors = {"x": x, **({"delta": delta} if delta is not None else {}),
               **({"scale": scale} if norm else {})}
    _check_cuda("llama_norm_quant", tensors, {n: torch.bfloat16 for n in tensors}, align=16)
    d = x.shape[-1]
    m = x.numel() // d
    if (delta is not None and (delta.shape != x.shape or not norm)) or (
            norm and scale.shape != (d,)) or (not norm and not n_groups):
        raise ValueError(f"llama_norm_quant: x {tuple(x.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, norm {norm}, "
                         f"n_groups {n_groups}: not a mode of the kernel")
    group = d // n_groups if n_groups else 0
    if d % 8 or d > 16384 or (n_groups and (d % n_groups or group % 8 or 32 % (group // 8))):
        raise ValueError(f"llama_norm_quant: d={d} or {n_groups} groups out of range")
    x_out = torch.empty_like(x) if delta is not None else x
    h = torch.empty_like(x) if norm else x
    xq = xs = None
    if n_groups:
        xq = torch.empty((m, d), dtype=torch.int8, device=x.device)
        xs = torch.empty((m, n_groups), dtype=torch.float32, device=x.device)
    mode = 0 if not norm else (2 if delta is not None else 1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("llama_norm_quant", x.data_ptr(), ptr(delta), ptr(scale) if norm else None,
                 ptr(x_out) if mode == 2 else None, ptr(h) if norm else None, ptr(xq),
                 ptr(xs), m, d, group, mode, eps, 1.0 / d, _stream(x.device))
    count_launch(launch_counts, "llama_norm_quant")
    return x_out, h, (xq, xs) if n_groups else None


def llama_rope_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     pos) -> torch.Tensor:
    """See llama_rope_cache_reference.

    CUDA: csrc/llama_rope_cache.cu, one launch; q, k, v and the cache
    bf16, the tables f32 (max_ctx, Dh/2); the rotated q in a new tensor.
    CPU: the plain version."""
    if q.device.type == "cpu":
        return llama_rope_cache_reference(q, k, v, ck, cv, cos, sin, pos)
    bf16, f32 = torch.bfloat16, torch.float32
    _check_cuda("llama_rope_cache", {"q": q, "k": k, "v": v, "ck": ck, "cv": cv, "cos": cos,
                                     "sin": sin},
                {"q": bf16, "k": bf16, "v": bf16, "ck": bf16, "cv": bf16, "cos": f32,
                 "sin": f32}, align=2)
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    s_len = ck.shape[1]
    if (k.shape != (b, t, kvh, dh) or v.shape != k.shape or ck.shape != (b, s_len, kvh * dh)
            or cv.shape != ck.shape or cos.shape != (cos.shape[0], dh // 2)
            or sin.shape != cos.shape or dh % 2 or t > s_len):
        raise ValueError(f"llama_rope_cache: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, cache {tuple(ck.shape)}, tables "
                         f"{tuple(cos.shape)}")
    pos_at, pos_i = _device_pos(pos, t, s_len, q.device)
    if pos_at is None and pos_i + t > cos.shape[0]:
        raise ValueError(f"positions up to {pos_i + t} exceed the tables' {cos.shape[0]}")
    q_out = torch.empty_like(q)
    build.launch("llama_rope_cache", q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
                 sin.data_ptr(), q_out.data_ptr(), ck.data_ptr(), cv.data_ptr(), b, t, h, kvh,
                 dh, s_len, cos.shape[0], pos_at, pos_i, _stream(q.device))
    count_launch(launch_counts, "llama_rope_cache")
    return q_out


def llama_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos) -> torch.Tensor:
    """See llama_attention_reference.

    CUDA: csrc/llama_attention.cu, one launch in the regime
    `attention_plan` names; bf16, 16-byte aligned, Dh in HEAD_DIMS, the
    kv heads dividing the query heads. The decode regime keeps the plain
    version's rounding points (bf16 weights normalised by the row's
    global max and sum); the prefill regime's online softmax rounds
    unnormalised weights. CPU: the plain version."""
    if q.device.type == "cpu":
        return llama_attention_reference(q, ck, cv, pos)
    bf16 = torch.bfloat16
    _check_cuda("llama_attention", {"q": q, "ck": ck, "cv": cv},
                {"q": bf16, "ck": bf16, "cv": bf16}, align=16)
    b, t, h, dh = q.shape
    s_len = ck.shape[1]
    kvh = ck.shape[-1] // max(dh, 1)
    if (dh not in HEAD_DIMS or ck.shape != (b, s_len, kvh * dh) or cv.shape != ck.shape
            or kvh < 1 or h % kvh or t > s_len):
        raise ValueError(f"llama_attention: q {tuple(q.shape)}, cache {tuple(ck.shape)}: "
                         f"head dim in {HEAD_DIMS}, kv heads dividing {h}, t ≤ S")
    pos_at, pos_i = _device_pos(pos, t, s_len, q.device)
    o = torch.empty((b, t, h * dh), dtype=bf16, device=q.device)
    build.launch("llama_attention", q.data_ptr(), ck.data_ptr(), cv.data_ptr(), o.data_ptr(),
                 b, t, h, kvh, dh, s_len, pos_at, pos_i, dh ** -0.5, _stream(q.device))
    count_launch(launch_counts, "llama_attention")
    return o


def llama_swiglu_quant(gate: torch.Tensor, up: torch.Tensor, n_groups: int = 0):
    """See llama_swiglu_quant_reference; gate, up (..., f) bf16.

    CUDA: csrc/llama_swiglu_quant.cu, one launch; f a multiple of 8, the
    group f / n_groups a multiple of 8 whose eighth divides 32. CPU: the
    plain version."""
    if gate.device.type == "cpu":
        return llama_swiglu_quant_reference(gate, up, n_groups)
    _check_cuda("llama_swiglu_quant", {"gate": gate, "up": up},
                {"gate": torch.bfloat16, "up": torch.bfloat16}, align=16)
    f = gate.shape[-1]
    m = gate.numel() // f
    group = f // n_groups if n_groups else 0
    if up.shape != gate.shape or f % 8 or not 1 <= m <= 65535 or (
            n_groups and (f % n_groups or group % 8 or 32 % (group // 8))):
        raise ValueError(f"llama_swiglu_quant: gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)}, {n_groups} groups out of range")
    out = torch.empty_like(gate)
    xq = xs = None
    if n_groups:
        xq = torch.empty((m, f), dtype=torch.int8, device=gate.device)
        xs = torch.empty((m, n_groups), dtype=torch.float32, device=gate.device)
    build.launch("llama_swiglu_quant", gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                 None if xq is None else xq.data_ptr(), None if xs is None else xs.data_ptr(),
                 m, f, group, _stream(gate.device))
    count_launch(launch_counts, "llama_swiglu_quant")
    return out, (xq, xs) if n_groups else None
