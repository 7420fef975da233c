"""The DeepSeek-V3 router (sigmoid scores, a selection-only bias, top-k)
as a kernel.

No JAX counterpart: the JAX package runs no mixture of experts. One
kernel, with a wrapper and a plain PyTorch version beside it:

* `moe_route`: for each row of h, s = sigmoid(h Wᵀ) in f32, the top_k
  experts of s + bias (largest first), their weights s[chosen] / (Σ +
  1e-20) · scale (DeepSeek-V3, arXiv:2412.19437, §2.1.2; the modeling
  code's `norm_topk_prob` and 1e-20), then the shared experts' ids at
  weight 1; csrc/moe_route.cu, one launch where the plain version takes
  about ten. Given a log (B, S, top_k) int32, the chosen ids of the t
  rows of each batch row are also written at positions pos..pos+t-1 (a
  host int or a 0-dim int64 device tensor): the served choices, which
  the caller may read back after a decode.

For CUDA tensors the wrapper checks them, launches the kernel on the
current stream and counts the launch in `launch_counts`; for CPU tensors
it runs the plain version; anything else raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .build import _check_cuda, _stream, count_launch
from .llama_ops import _device_pos

MAX_EXPERTS, MAX_TOP_K = 256, 16      # csrc/moe_route.cu's limits

# kernel name → launches since the last reset_launch_counts()
launch_counts = {"moe_route": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def moe_route_reference(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        shared: torch.Tensor, top_k: int, scale: float, norm: bool = True,
                        log: torch.Tensor | None = None, pos=0):
    """h (T, d), W (E, d) → (ids (T, top_k + n_shared) int64, weights
    f32): the top_k of sigmoid(h Wᵀ) (f32) + bias, their sigmoid scores
    normalized (with `norm`) and scaled, then the shared experts at
    weight 1."""
    s = torch.sigmoid(h.float() @ w.float().T)
    chosen = (s + bias).topk(top_k, dim=-1).indices
    wt = s.gather(-1, chosen)
    if norm:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    t = h.shape[0]
    if log is not None:
        b = log.shape[0]
        positions = pos + torch.arange(t // b, device=h.device)
        log.index_copy_(1, positions, chosen.view(b, t // b, top_k).to(log.dtype))
    ids = torch.cat([chosen, shared.expand(t, shared.shape[0])], -1)
    return ids, F.pad(wt * scale, (0, shared.shape[0]), value=1.0)


def moe_route(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, shared: torch.Tensor,
              top_k: int, scale: float, norm: bool = True, log: torch.Tensor | None = None,
              pos=0):
    """See moe_route_reference; h (T, d) bf16, w (E, d) bf16, bias (E,)
    f32, shared (n_shared,) int64.

    CUDA: csrc/moe_route.cu, one launch, a cluster of up to 8 blocks a
    row; E ≤ 256, top_k ≤ 16, d a multiple of 8 up to 16384, w 16-byte
    aligned. Its f32 dot products are summed in another order than the
    plain version's matmul, so a choice between two experts whose scores
    tie to an ulp may differ. CPU: the plain version."""
    if h.device.type == "cpu":
        return moe_route_reference(h, w, bias, shared, top_k, scale, norm, log, pos)
    _check_cuda("moe_route", {"h": h, "w": w, "bias": bias, "shared": shared},
                {"h": torch.bfloat16, "w": torch.bfloat16, "bias": torch.float32,
                 "shared": torch.int64}, align={"h": 2, "w": 16, "bias": 4, "shared": 8})
    t, d = h.shape
    e = w.shape[0]
    if (w.shape != (e, d) or bias.shape != (e,) or shared.dim() != 1 or not 1 <= e <= MAX_EXPERTS
            or not 1 <= top_k <= min(MAX_TOP_K, e) or d % 8 or d > 16384):
        raise ValueError(f"moe_route: h {tuple(h.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)}, shared {tuple(shared.shape)}, top_k {top_k}")
    pos_at, pos_i, t_rows, s_len = None, 0, 1, 1
    if log is not None:
        _check_cuda("moe_route", {"log": log}, {"log": torch.int32}, align=4)
        s_len, t_rows = log.shape[1], t // log.shape[0]
        if log.shape != (log.shape[0], s_len, top_k) or t % log.shape[0]:
            raise ValueError(f"moe_route: log {tuple(log.shape)} for {t} rows, top_k {top_k}")
        pos_at, pos_i = _device_pos(pos, t_rows, s_len, h.device)
    a = top_k + shared.shape[0]
    ids = torch.empty((t, a), dtype=torch.int64, device=h.device)
    weights = torch.empty((t, a), dtype=torch.float32, device=h.device)
    build.launch("moe_route", h.data_ptr(), w.data_ptr(), bias.data_ptr(), shared.data_ptr(),
                 ids.data_ptr(), weights.data_ptr(), None if log is None else log.data_ptr(),
                 pos_at, pos_i, t_rows, s_len, t, d, e, top_k, shared.shape[0], int(norm), scale,
                 _stream(h.device))
    count_launch(launch_counts, "moe_route")
    return ids, weights
