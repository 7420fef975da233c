"""Attention kernels of the greedy path: CUDA wrappers and plain twins.

Port of turbo_whisper_workspace_tpu/ops/attention.py (flash_attention,
cross_attention_int8, quantize_cross_kv_int8). Each kernel has:

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

NEG_INF = -1e30
HEAD_DIM = 64     # the kernels' head dim (every Whisper size)

# kernel name → launches since the last reset_launch_counts()
launch_counts = {name: 0 for name in build.SIGNATURES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_cuda(name: str, tensors: dict, dtypes: dict, align: int,
                contiguous: bool = True) -> None:
    """Device, dtype, contiguity and alignment checks before a launch
    (`align`: the widest load, in bytes, the kernel makes)."""
    device = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be on {device} (CUDA), got {t.device}")
        if t.dtype != dtypes[arg]:
            raise ValueError(f"{name}: {arg} must be {dtypes[arg]}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {arg} must be {align}-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# flash_attention (encoder self-attention)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain non-causal attention with the TPU kernel's math
    (_one_pass_kernel): f32 scores scaled by d^-1/2·log2 e, exp2 softmax,
    weights cast to q's dtype before PV with f32 sums. (B, H, T, D)."""
    scale = (q.shape[-1] ** -0.5) * math.log2(math.e)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = (p / p.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal full attention, (B, H, T, 64) → (B, H, T, 64).

    CUDA: csrc/flash_attention.cu, bf16 only. q, k and v may be strided
    views (the encoder passes (B, T, H·64) projections viewed as
    (B, H, T, 64)) as long as they share strides and each row of 64 is
    dense; the output has the same strides. CPU: the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
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
    launch_counts["flash_attention"] += 1
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
    scale = (dh ** -0.5) * math.log2(math.e)
    qs = (q.float() * (k_scale[:, :, None, None] * scale)).to(torch.bfloat16)
    scores = torch.einsum("bhqd,bhdt->bhqt", qs.float(), kq.float())
    if seq_len < tpad:
        scores[..., seq_len:] = NEG_INF
    p = torch.exp2(scores - scores.amax(-1, keepdim=True))
    w = (p / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    vh = vq.reshape(b, tpad, h, dh)
    out = torch.einsum("bhqt,bthd->bhqd", w.float(), vh.float())
    return (out * v_scale[:, :, None, None]).to(q.dtype)


def cross_attention_int8(q, kq, vq, k_scale, v_scale,
                         seq_len: int | None = None) -> torch.Tensor:
    """Decode cross-attention over int8 K/V; returns (B, H, Tq, 64).

    CUDA: csrc/cross_attention_int8.cu, bf16 q. CPU: the plain version."""
    if q.device.type == "cpu":
        return cross_attention_int8_reference(q, kq, vq, k_scale, v_scale, seq_len)
    _check_cuda("cross_attention_int8",
                {"q": q, "kq": kq, "vq": vq, "k_scale": k_scale, "v_scale": v_scale},
                {"q": torch.bfloat16, "kq": torch.int8, "vq": torch.int8,
                 "k_scale": torch.float32, "v_scale": torch.float32}, align=4)
    b, h, tq, dh = q.shape
    tpad = kq.shape[-1]
    seq_len = tpad if seq_len is None else seq_len
    if (dh != HEAD_DIM or kq.shape != (b, h, dh, tpad)
            or vq.shape != (b, tpad, h * dh) or k_scale.shape != (b, h)
            or v_scale.shape != (b, h)):
        raise ValueError(
            "cross_attention_int8: expected q (B, H, Tq, 64), kq (B, H, 64, Tpad), "
            f"vq (B, Tpad, H·64), scales (B, H); got {q.shape}, {kq.shape}, "
            f"{vq.shape}, {k_scale.shape}, {v_scale.shape}")
    if tpad % 4 or not 1 <= seq_len <= tpad or tq < 1:
        raise ValueError(f"cross_attention_int8: Tpad={tpad} (multiple of 4), "
                         f"seq_len={seq_len}, Tq={tq} out of range")
    out = torch.empty_like(q)
    build.launch("cross_attention_int8", q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                 b, h, tq, tpad, seq_len, _stream(q.device))
    launch_counts["cross_attention_int8"] += 1
    return out
