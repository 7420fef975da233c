"""Attention kernels of the decode paths: CUDA wrappers and plain twins.

Port of turbo_whisper_workspace_tpu/ops/attention.py (flash_attention,
cross_attention_int8, cross_attention_s8, quantize_cross_kv_int8,
self_attention_int8, self_attention_int8_lanes, self_attention_int8_xla).
Each kernel has:

* a wrapper that, for CUDA tensors, checks them, allocates the output,
  launches the hand-written CUDA C++ kernel (csrc/) on the current
  stream and counts the launch in `launch_counts`; for CPU tensors it
  runs the plain version (the CPU tests); anything else raises;
* a plain PyTorch version with the TPU kernel's math (exp2 with log2 e
  folded into the scale, f32 softmax), which the tests hold against the
  JAX package and `chip_smoke.py` holds the kernel against on the card.
"""

from __future__ import annotations

import math

import torch

from . import build
from .build import _check_cuda, _stream, count_launch

NEG_INF = -1e30
HEAD_DIM = 64     # the kernels' head dim (every Whisper size)
MAX_BEAMS = 8     # self_attention_int8_lanes: 8-bit owner masks of (lane, t) pairs
CLUSTER_MAX_RANKS = 8   # blocks a cluster holds in the plans below (the portable size)
LOG2E = math.log2(math.e)

# kernel name → launches since the last reset_launch_counts()
launch_counts = {name: 0 for name in ("flash_attention", "cross_attention_int8",
                                      "cross_attention_s8", "self_attention_int8",
                                      "self_attention_int8_lanes")}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. PyTorch's CUDA kernels
    turn a division by a Python scalar into a product with its
    reciprocal, which is off by an ulp now and then; a tensor divisor
    keeps the card's results bit-equal to the CPU's."""
    return x / torch.full_like(x, d)


# ---------------------------------------------------------------------------
# flash_attention (encoder self-attention)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain non-causal attention with the TPU kernel's math
    (_one_pass_kernel): f32 scores scaled by d^-1/2·log2 e, exp2 softmax,
    weights cast to q's dtype before PV with f32 sums. (B, H, T, D)."""
    scale = q.shape[-1] ** -0.5 * LOG2E
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = (p / p.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal full attention, (B, H, T, 64) → (B, H, T, 64).

    CUDA: csrc/flash_attention.cu, bf16 only. q, k and v may be strided
    views (the encoder passes (B, T, H·64) projections viewed as
    (B, H, T, 64)) as long as they share strides and each row of 64 is
    dense; the output has the same strides. When autograd records (a
    training step), the kernel's forward goes behind FlashAttention,
    whose backward recomputes the weights in torch ops; otherwise
    nothing is saved. CPU: the plain version (autograd differentiates
    it)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return _flash_attention_launch(q, k, v)


def flash_attention_backward(q, k, v, grad_out):
    """The standard attention backward of softmax(q·kᵀ/√d)·v, the
    weights recomputed from q and k in f32: dV = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ∘ (dP − rowsum(dP ∘ P)), dQ = dS·K/√d, dK = dSᵀ·Q/√d. The
    JAX package has no backward kernel (its flash_attention has no
    custom_vjp), so this is torch ops on every device."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), grad_out.float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """flash_attention with a gradient: the forward launches the kernel,
    the backward is flash_attention_backward on the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_attention_launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return flash_attention_backward(*ctx.saved_tensors, grad_out)


def _flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _check_cuda("flash_attention", {"q": q, "k": k, "v": v},
                dict.fromkeys("qkv", torch.bfloat16), align=16, contiguous=False)
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d != HEAD_DIM:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, T, {HEAD_DIM}) "
                         f"alike, got {q.shape}, {k.shape}, {v.shape}")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or strides[-1] != 1 or any(
            s % 8 for s in strides[:-1]):
        raise ValueError("flash_attention: q, k, v must share strides, with unit "
                         "stride along the head dim and 16-byte aligned rows; got "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if not 1 <= b * h <= 65535 or t < 1:
        raise ValueError(f"flash_attention: B·H={b * h} and T={t} out of range")
    out = torch.empty_like(q)     # keeps q's strides (q is dense)
    if out.stride() != strides:
        raise ValueError(f"flash_attention: q must be dense, got strides {strides}")
    stride_b, stride_h, stride_t, _ = strides
    build.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, t, stride_b, stride_h, stride_t,
                 _stream(q.device))
    count_launch(launch_counts, "flash_attention")
    return out


# ---------------------------------------------------------------------------
# cross_attention_int8 (decoder cross-attention over int8 K/V)


def quantize_cross_kv_int8(k: torch.Tensor, v: torch.Tensor) -> dict:
    """(L, B, H, T, Dh) K/V → int8 with per-(L, B, H) f32 scales, T padded
    to a multiple of 128: K (L, B, H, Dh, Tpad), V (L, B, Tpad, H·Dh).
    Rounds half to even, as the JAX function does, so the payload is
    bit-equal to it."""
    l, b, h, t, dh = k.shape
    tpad = -(-t // 128) * 128

    def quant(x):
        xf = x.float()
        s = (xf.abs().amax(dim=(-2, -1)) / 127.0).clamp_min(1e-12)
        xq = torch.clamp(torch.round(xf / s[..., None, None]), -127, 127)
        return xq.to(torch.int8), s

    kq, ks = quant(k)
    vq, vs = quant(v)
    kq = torch.nn.functional.pad(kq.transpose(-1, -2), (0, tpad - t))
    vq = vq.permute(0, 1, 3, 2, 4).reshape(l, b, t, h * dh)
    vq = torch.nn.functional.pad(vq, (0, 0, 0, tpad - t))
    return {"k_q": kq.contiguous(), "v_q": vq.contiguous(),
            "k_scale": ks.contiguous(), "v_scale": vs.contiguous()}


def cross_attention_int8_reference(q, kq, vq, k_scale, v_scale,
                                   seq_len: int | None = None) -> torch.Tensor:
    """Plain version with the TPU kernel's rounding points
    (_bd_attn_int8_kernel): q·(k_scale·d^-1/2·log2 e) rounded to bf16,
    f32 scores, columns ≥ seq_len masked, exp2 softmax, weights rounded
    to bf16, f32 PV, × v_scale in f32, one rounding to q's dtype.
    q (B, H, Tq, Dh); kq (B, H, Dh, Tpad); vq (B, Tpad, H·Dh) int8."""
    b, h, tq, dh = q.shape
    tpad = kq.shape[-1]
    seq_len = tpad if seq_len is None else seq_len
    scale = dh ** -0.5 * LOG2E
    qs = (q.float() * (k_scale[:, :, None, None] * scale)).to(torch.bfloat16)
    scores = torch.einsum("bhqd,bhdt->bhqt", qs.float(), kq.float())
    if seq_len < tpad:
        scores[..., seq_len:] = NEG_INF
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = (p / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    vh = vq.reshape(b, tpad, h, dh)
    out = torch.einsum("bhqt,bthd->bhqd", w.float(), vh.float())
    return (out * v_scale[:, :, None, None]).to(q.dtype)


# the plan of both cross-attention kernels mirrors cross_plan in
# csrc/cluster_attention.cuh
CROSS_KEYS_PER_RANK = 128    # the slice the plan aims at before rounding
CROSS_MAX_SLICE = 1024       # keys one block holds in shared memory


def cross_int8_plan(tq: int, tpad: int) -> tuple[int, int, int]:
    """The launch plan of cross_attention_int8 and cross_attention_s8 →
    (ranks C, slice S, query chunk): one cluster of C ≤ 8 blocks per
    (b, h), rank r holding keys [r·S, (r+1)·S), S a multiple of 16 with
    C·S ≥ Tpad and no rank wholly past Tpad; query rows go in even
    chunks of at most 8. Only Tq and Tpad enter: the (b, h) count only
    multiplies the clusters, and seq_len only trims each slice's loads
    and sums (a rank past it still joins its cluster's barriers)."""
    ranks = min(CLUSTER_MAX_RANKS, max(1, -(-tpad // CROSS_KEYS_PER_RANK)))
    slice_keys = -(-(-(-tpad // ranks)) // 16) * 16
    ranks = -(-tpad // slice_keys)
    chunks = -(-tq // 8)
    return ranks, slice_keys, -(-tq // chunks)


def cross_attention_int8(q, kq, vq, k_scale, v_scale,
                         seq_len: int | None = None) -> torch.Tensor:
    """Decode cross-attention over int8 K/V; returns (B, H, Tq, 64).

    CUDA: csrc/cross_attention_int8.cu, one thread-block cluster per
    (b, h) as `cross_int8_plan` says; bf16 q, Tpad a multiple of 16 and
    at most 8 · CROSS_MAX_SLICE, K/V 16-byte aligned. CPU: the plain
    version."""
    if q.device.type == "cpu":
        return cross_attention_int8_reference(q, kq, vq, k_scale, v_scale, seq_len)
    seq_len = _check_cross("cross_attention_int8", q, kq, vq, k_scale, v_scale, seq_len)
    b, h, tq, _ = q.shape
    out = torch.empty_like(q)
    build.launch("cross_attention_int8", q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                 b, h, tq, kq.shape[-1], seq_len, _stream(q.device))
    count_launch(launch_counts, "cross_attention_int8")
    return out


def _check_cross(name: str, q, kq, vq, k_scale, v_scale, seq_len: int | None) -> int:
    """The CUDA cross-attention kernels' checks (both launch on
    `cross_int8_plan`, with 16-byte copies of K and V); returns seq_len."""
    _check_cuda(name, {"q": q, "kq": kq, "vq": vq, "k_scale": k_scale, "v_scale": v_scale},
                {"q": torch.bfloat16, "kq": torch.int8, "vq": torch.int8,
                 "k_scale": torch.float32, "v_scale": torch.float32},
                align={"q": 2, "kq": 16, "vq": 16, "k_scale": 4, "v_scale": 4})
    b, h, tq, dh = q.shape
    tpad = kq.shape[-1]
    seq_len = tpad if seq_len is None else seq_len
    if (dh != HEAD_DIM or kq.shape != (b, h, dh, tpad)
            or vq.shape != (b, tpad, h * dh) or k_scale.shape != (b, h)
            or v_scale.shape != (b, h)):
        raise ValueError(
            f"{name}: expected q (B, H, Tq, 64), kq (B, H, 64, Tpad), "
            f"vq (B, Tpad, H·64), scales (B, H); got {q.shape}, {kq.shape}, "
            f"{vq.shape}, {k_scale.shape}, {v_scale.shape}")
    if (tpad % 16 or tpad > CLUSTER_MAX_RANKS * CROSS_MAX_SLICE
            or not 1 <= seq_len <= tpad or tq < 1):
        raise ValueError(f"{name}: Tpad={tpad} (a multiple of 16, at most "
                         f"{CLUSTER_MAX_RANKS * CROSS_MAX_SLICE}), seq_len={seq_len}, "
                         f"Tq={tq} out of range")
    return seq_len


def cross_attention_s8_reference(q, kq, vq, k_scale, v_scale,
                                 seq_len: int | None = None) -> torch.Tensor:
    """Plain version with the TPU kernel's rounding points
    (_bd_attn_s8_kernel and its wrapper): q·(k_scale·d^-1/2·log2 e)
    rounded to bf16; each (b, h, query) row quantized to int8 at
    qs = max(amax, 1e-30)/127, round half to even, clipped to ±127;
    scores = f32(s32 dot with kq) · qs, columns ≥ seq_len masked, exp2
    softmax with the weights as p · (1/Σp); the weights quantized per row
    at wscale = max(max w, 1e-30)/127 (no clip: w ≤ max w); out =
    f32(s32 Σ w8·vq) · wscale, × v_scale in f32, one rounding to q's
    dtype. The integer products run in float64, exact at every sum.
    q (B, H, Tq, Dh); kq (B, H, Dh, Tpad); vq (B, Tpad, H·Dh) int8."""
    b, h, tq, dh = q.shape
    tpad = kq.shape[-1]
    seq_len = tpad if seq_len is None else seq_len
    scale = dh ** -0.5 * LOG2E
    qf = (q.float() * (k_scale[:, :, None, None] * scale)).to(torch.bfloat16).float()
    qs = _div(qf.abs().amax(-1, keepdim=True).clamp_min(1e-30), 127.0)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127)
    dots = torch.einsum("bhqd,bhdt->bhqt", q8.double(), kq.double())
    scores = dots.float() * qs
    scores[..., seq_len:] = NEG_INF
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = p * torch.reciprocal(p.sum(-1, keepdim=True))
    wscale = _div(w.amax(-1, keepdim=True).clamp_min(1e-30), 127.0)
    w8 = torch.round(w / wscale)
    vh = vq.reshape(b, tpad, h, dh)
    out = torch.einsum("bhqt,bthd->bhqd", w8.double(), vh.double()).float() * wscale
    return (out * v_scale[:, :, None, None]).to(q.dtype)


def cross_attention_s8(q, kq, vq, k_scale, v_scale,
                       seq_len: int | None = None) -> torch.Tensor:
    """Decode cross-attention over int8 K/V with the query and the
    softmax weights quantized per row to int8, both products s8×s8 into
    s32; returns (B, H, Tq, 64). The opt-in twin of cross_attention_int8
    (TranscriptionConfig.cross_attention_s8).

    CUDA: csrc/cross_attention_s8.cu, one thread-block cluster per
    (b, h) on `cross_int8_plan`, as cross_attention_int8; bf16 q, Tpad a
    multiple of 16 and at most 8 · CROSS_MAX_SLICE, K/V 16-byte aligned.
    CPU: the plain version."""
    if q.device.type == "cpu":
        return cross_attention_s8_reference(q, kq, vq, k_scale, v_scale, seq_len)
    seq_len = _check_cross("cross_attention_s8", q, kq, vq, k_scale, v_scale, seq_len)
    b, h, tq, _ = q.shape
    out = torch.empty_like(q)
    build.launch("cross_attention_s8", q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                 b, h, tq, kq.shape[-1], seq_len, _stream(q.device))
    count_launch(launch_counts, "cross_attention_s8")
    return out


# ---------------------------------------------------------------------------
# Decoder self-attention over the int8 self-KV cache (beam search)


def self_attention_int8_xla(q, kq, ks, vq, vs, mask: torch.Tensor) -> torch.Tensor:
    """Masked attention over an int8 (B, H, T, Dh) cache with per-(head,
    position) scales ks, vs (B, H, T); mask broadcasts to (B, H, Tq, T).

    This is the JAX package's XLA path (self_attention_int8_xla), which
    it runs for the quantized prefill (Tq > 1, causal mask) on every
    backend; there is no kernel for it there either, so it is plain
    torch on the card too, not a fallback. f32 logits and softmax,
    weights × vs rounded to q's dtype, PV summed in f32 and rounded to
    q's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float())
    logits = logits * (ks.float()[:, :, None, :] * scale)
    weights = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    weights = (weights * vs.float()[:, :, None, :]).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights.float(), vq.float()).to(q.dtype)


def self_attention_int8_reference(q, kq, ks, vq, vs,
                                  valid_len: int | torch.Tensor) -> torch.Tensor:
    """Plain version with the TPU kernel's rounding points
    (_self_int8_kernel): f32 scores q·kq × ks·d^-1/2·log2 e, keys at
    t ≥ valid_len masked, exp2 softmax in f32, weights × vs rounded to
    q's dtype, f32 PV, one rounding to q's dtype.
    q (B, H, Tq, Dh); kq, vq (B, H, T, Dh) int8; ks, vs (B, H, T);
    valid_len an int or a one-element tensor on q's device (the mask is
    built on the device: no host read)."""
    scale = q.shape[-1] ** -0.5 * LOG2E
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float())
    scores = scores * (ks.float()[:, :, None, :] * scale)
    scores = scores.masked_fill(torch.arange(kq.shape[2], device=q.device) >= valid_len,
                                NEG_INF)
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = p / p.sum(-1, keepdim=True)
    w = (w * vs.float()[:, :, None, :]).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), vq.float()).to(q.dtype)


SELF_MAX_KEYS = 1536         # cache length T whose K/V slabs one block holds in shared memory


def _device_valid_len(name: str, valid_len: int | torch.Tensor, t: int,
                      device: torch.device) -> torch.Tensor:
    """The key count as the kernels read it: one int32 in device memory
    (the TPU kernels' scalar prefetch). A host int (an eager caller) goes
    into a new tensor after a range check; a tensor (the beam step a CUDA
    graph replays) is taken as it is, never read on the host: the kernel
    clamps it to [1, T]."""
    if not torch.is_tensor(valid_len):
        if not 1 <= valid_len <= t:
            raise ValueError(f"{name}: valid_len={valid_len} out of [1, T={t}]")
        return torch.tensor([valid_len], dtype=torch.int32, device=device)
    if valid_len.device != device or valid_len.dtype != torch.int32 or valid_len.numel() != 1:
        raise ValueError(f"{name}: a tensor valid_len must be one int32 on {device}, got "
                         f"{valid_len.dtype} {tuple(valid_len.shape)} on {valid_len.device}")
    return valid_len


def self_attention_int8(q, kq, ks, vq, vs, valid_len: int | torch.Tensor) -> torch.Tensor:
    """One decode step of self-attention over the int8 cache; returns
    (B, H, Tq, 64). Keys t < valid_len count: an int, or a one-element
    int32 tensor on q's device, which the kernel reads from device memory.

    CUDA: csrc/self_attention_int8.cu, bf16 q and scales; kq and vq
    16-byte aligned (each (b, h)'s first valid_len rows are one bulk
    copy); T ≤ SELF_MAX_KEYS (the launch is sized by T alone). CPU: the
    plain version."""
    if q.device.type == "cpu":
        return self_attention_int8_reference(q, kq, ks, vq, vs, valid_len)
    _check_cuda("self_attention_int8",
                {"q": q, "kq": kq, "ks": ks, "vq": vq, "vs": vs},
                {"q": torch.bfloat16, "kq": torch.int8, "ks": torch.bfloat16,
                 "vq": torch.int8, "vs": torch.bfloat16},
                align={"q": 2, "kq": 16, "ks": 2, "vq": 16, "vs": 2})
    b, h, tq, dh = q.shape
    t = kq.shape[2]
    if (dh != HEAD_DIM or kq.shape != (b, h, t, dh) or vq.shape != kq.shape
            or ks.shape != (b, h, t) or vs.shape != ks.shape):
        raise ValueError(
            "self_attention_int8: expected q (B, H, Tq, 64), kq and vq (B, H, T, 64), "
            f"ks and vs (B, H, T); got {q.shape}, {kq.shape}, {vq.shape}, "
            f"{ks.shape}, {vs.shape}")
    if not 1 <= t <= SELF_MAX_KEYS or tq < 1 or b * h < 1:
        raise ValueError(f"self_attention_int8: T={t} (at most {SELF_MAX_KEYS}), "
                         f"Tq={tq}, B·H={b * h} out of range")
    valid_len = _device_valid_len("self_attention_int8", valid_len, t, q.device)
    out = torch.empty_like(q)
    build.launch("self_attention_int8", q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                 vq.data_ptr(), vs.data_ptr(), out.data_ptr(), b * h, tq, t,
                 valid_len.data_ptr(), _stream(q.device))
    count_launch(launch_counts, "self_attention_int8")
    return out


def self_attention_int8_lanes_reference(q, kq, ks, vq, vs, lane_map: torch.Tensor,
                                        valid_len: int | torch.Tensor) -> torch.Tensor:
    """Plain version of the beam step over the lane cache, with the TPU
    kernel's rounding points (_bd_self_int8_kernel): for beam k, key
    column j = l·T + t counts only when lane l == lane_map[b, k, t] and
    t < valid_len; f32 scores × ks·d^-1/2·log2 e, exp2 softmax, weights ×
    vs rounded to q's dtype, f32 PV, one rounding to q's dtype.
    q (B, H, K, Dh); kq (B, H·Dh, K·T) and vq (B, K·T, H·Dh) int8 panels;
    ks, vs (B, H, K·T); lane_map (B, K, T) int; valid_len an int or a
    one-element tensor on q's device (no host read)."""
    b, h, k, dh = q.shape
    kt = kq.shape[-1]
    t = kt // k
    scale = dh ** -0.5 * LOG2E
    scores = torch.einsum("bhkd,bhdj->bhkj", q.float(), kq.reshape(b, h, dh, kt).float())
    scores = scores * (ks.float()[:, :, None, :] * scale)
    lanes = torch.arange(k, device=q.device)[None, None, :, None]
    keep = (lane_map[:, :, None, :] == lanes) & (
        torch.arange(t, device=q.device) < valid_len)            # (B, K, K lanes, T)
    scores = scores.masked_fill(~keep.reshape(b, 1, k, kt), NEG_INF)
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = p / p.sum(-1, keepdim=True)
    w = (w * vs.float()[:, :, None, :]).to(q.dtype)
    vh = vq.reshape(b, kt, h, dh)
    return torch.einsum("bhkj,bjhd->bhkd", w.float(), vh.float()).to(q.dtype)


# self_attention_int8_lanes's plan mirrors csrc/self_attention_int8_lanes.cu:make_plan
LANES_T_PER_RANK = 32        # positions a rank aims at before rounding
LANES_MAX_T = 1024           # positions one cluster holds in shared memory


def lanes_plan(t_len: int) -> tuple[int, int]:
    """self_attention_int8_lanes's launch plan → (ranks C, slice S): one
    cluster of C ≤ 8 blocks per (b, h), rank r holding positions
    [r·S, (r+1)·S) of the cache's [0, T), C·S ≥ T and no rank wholly past
    it. Only the cache length T enters (a CUDA graph fixes the launch);
    the ranks whose slice lies past valid_len own no position."""
    ranks = min(CLUSTER_MAX_RANKS, max(1, -(-t_len // LANES_T_PER_RANK)))
    slice_t = -(-t_len // ranks)
    return -(-t_len // slice_t), slice_t


def self_attention_int8_lanes(q, kq, ks, vq, vs, lane_map: torch.Tensor,
                              valid_len: int | torch.Tensor) -> torch.Tensor:
    """Beam-decode self-attention over the un-reordered lane cache;
    returns (B, H, K, 64). The kernel reads `lane_map` itself; the TPU
    wrapper's additive (B, K, K·T) bias is not built. `valid_len` is an
    int or a one-element int32 tensor on q's device, which the kernel
    reads from device memory.

    CUDA: csrc/self_attention_int8_lanes.cu, one thread-block cluster
    per (b, h) as `lanes_plan` says; bf16 q and scales, int32 lane_map,
    K ≤ 8 beams, T ≤ LANES_MAX_T, the V panel 16-byte aligned. CPU: the
    plain version."""
    if q.device.type == "cpu":
        return self_attention_int8_lanes_reference(q, kq, ks, vq, vs, lane_map, valid_len)
    _check_cuda("self_attention_int8_lanes",
                {"q": q, "kq": kq, "ks": ks, "vq": vq, "vs": vs, "lane_map": lane_map},
                {"q": torch.bfloat16, "kq": torch.int8, "ks": torch.bfloat16,
                 "vq": torch.int8, "vs": torch.bfloat16, "lane_map": torch.int32},
                align={"q": 2, "kq": 1, "ks": 2, "vq": 16, "vs": 2, "lane_map": 4})
    b, h, k, dh = q.shape
    kt = kq.shape[-1]
    t = kt // k
    if (dh != HEAD_DIM or kt != k * t or kq.shape != (b, h * dh, kt)
            or vq.shape != (b, kt, h * dh) or ks.shape != (b, h, kt)
            or vs.shape != ks.shape or lane_map.shape != (b, k, t)):
        raise ValueError(
            "self_attention_int8_lanes: expected q (B, H, K, 64), kq (B, H·64, K·T), "
            "vq (B, K·T, H·64), ks and vs (B, H, K·T), lane_map (B, K, T); got "
            f"{q.shape}, {kq.shape}, {vq.shape}, {ks.shape}, {vs.shape}, {lane_map.shape}")
    if not 1 <= k <= MAX_BEAMS or not 1 <= t <= LANES_MAX_T or b * h < 1:
        raise ValueError(f"self_attention_int8_lanes: K={k} (at most {MAX_BEAMS}), "
                         f"T={t} (at most {LANES_MAX_T}), B·H={b * h} out of range")
    valid_len = _device_valid_len("self_attention_int8_lanes", valid_len, t, q.device)
    out = torch.empty_like(q)
    build.launch("self_attention_int8_lanes", q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                 vq.data_ptr(), vs.data_ptr(), lane_map.data_ptr(), out.data_ptr(),
                 b, h, k, t, valid_len.data_ptr(), _stream(q.device))
    count_launch(launch_counts, "self_attention_int8_lanes")
    return out
