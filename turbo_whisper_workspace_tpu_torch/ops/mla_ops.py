"""Multi-head latent attention (MLA) over a latent cache: the kernel of
the DeepSeek-V3 decode step.

No JAX counterpart: the JAX package runs no MLA model. One kernel, with
a wrapper and a plain PyTorch version beside it:

* `mla_attention`: the decode step's latent attention in the absorbed
  form (DeepSeek-V2, arXiv:2405.04434, §2.1.3), with the step's cache
  work: RoPE of the queries' and the new token's rope parts at the
  position, the new cache row [c_kv, rotated k_pe] written there, then
  every head's 576-wide query [q_lat, rotated q_pe] over the rows 0..pos
  (f32 scores scaled by `scale`, f32 softmax), the weights' sum of the
  rows' 512 latent columns returned; csrc/mla_attention.cu.

For CUDA tensors the wrapper checks them, launches the kernel on the
current stream and counts the launch in `launch_counts` (and, where its
cluster takes 16 ranks, calls `mla_cluster_launch`); for CPU tensors it
runs the plain version; anything else raises. `pos` is a host int or
a 0-dim int64 tensor on the tensors' device, read by the kernel from
device memory (a decode step a CUDA graph replays).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .build import _check_cuda, _stream, count_launch
from .llama_ops import _device_pos, apply_rope

LATENT, ROPE = 512, 64      # the kernel's widths: kv_lora_rank and qk_rope_head_dim
HEADS_A_BLOCK = 16          # query heads a block: the mma's rows
# csrc/mla_attention.cu's plan, mirrored
KEYS_PER_RANK = 64          # the slice aimed at before the ranks are capped
WIDE_RANKS = 16             # a cluster where the card holds every one of the launch
PORTABLE_RANKS = 8          # else
WAVE_BLOCKS = 132
RESIDENT_ROWS = 160         # a rank's rows in shared memory at once; more stream in rounds

# kernel name → launches since the last reset_launch_counts()
launch_counts = {"mla_attention": 0}
# the launches whose cluster took WIDE_RANKS blocks (mla_cluster_launch)
cluster_launch_counts = {f"mla_attention.cluster{WIDE_RANKS}": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, cluster_launch_counts):
        for name in counts:
            counts[name] = 0


def ranks(s_len: int, clusters: int, wide_clusters: int) -> int:
    """The blocks of a cluster (csrc/mla_attention.cu:plan_ranks): slices
    of about KEYS_PER_RANK cache rows, one wave of blocks at most, and
    WIDE_RANKS where the card holds all `clusters` at that size
    (`wide_clusters`: the kernel's occupancy query, `kernel_wide_clusters`),
    else PORTABLE_RANKS; rounded down to a power of two."""
    cap = WIDE_RANKS if max(clusters, 1) <= wide_clusters else PORTABLE_RANKS
    r = min(-(-s_len // KEYS_PER_RANK), WAVE_BLOCKS // max(clusters, 1), cap)
    return 1 << (max(r, 1).bit_length() - 1)


def _entry(name: str, argtypes: list):
    entry = getattr(build.library("mla_attention"), name)
    entry.argtypes = argtypes
    entry.restype = ctypes.c_int
    return entry


def kernel_ranks(s_len: int, clusters: int) -> int:
    """The ranks the built library launches with (the card's machine):
    the check that `ranks` mirrors it."""
    return _entry("tww_mla_attention_ranks", [ctypes.c_int, ctypes.c_int])(s_len, clusters)


def kernel_wide_clusters() -> int:
    """The kernel's 16-block clusters the card holds at once (the
    library's occupancy query, asked once a process; 0: it keeps
    PORTABLE_RANKS)."""
    return _entry("tww_mla_attention_wide_clusters", [])()


@functools.lru_cache(maxsize=None)
def _launch_ranks(s_len: int, clusters: int) -> int:
    return kernel_ranks(s_len, clusters)


def mla_cluster_launch(n_ranks: int) -> None:
    """Count one mla_attention launch over a cluster of `n_ranks` blocks
    (WIDE_RANKS, the non-portable size), as count_launch counts; the
    wrapper calls it beside each such launch, so a profiler that wraps it
    sees each."""
    count_launch(cluster_launch_counts, f"mla_attention.cluster{n_ranks}")


def mla_attention_reference(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                            k_pe: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                            cache: torch.Tensor, pos, scale: float) -> torch.Tensor:
    """q_lat (B, t, H, L) and the un-rotated q_pe (B, t, H, R) of t query
    rows at positions pos..pos+t-1; c_kv (B, t, L), k_pe (B, t, R) of the
    new rows; cos, sin (max_ctx, R/2) f32; cache (B, S, L + R), written
    in place at those rows with [c_kv, rotated k_pe] → (B, t, H, L) in
    q_lat's dtype: f32 scores [q_lat, rotated q_pe] · row · scale over
    rows ≤ the query's position, f32 softmax, the weights' f32 sum of the
    rows' first L columns, one rounding."""
    b, t, h, lat = q_lat.shape
    s_len = cache.shape[1]
    positions = pos + torch.arange(t, device=q_lat.device)
    rows = tuple(tab.index_select(0, positions)[None, :, None, :] for tab in (cos, sin))
    q_rot = apply_rope(q_pe, *rows)
    k_rot = apply_rope(k_pe[:, :, None], *rows)[:, :, 0]
    cache.index_copy_(1, positions, torch.cat([c_kv, k_rot], -1).to(cache.dtype))
    q = torch.cat([q_lat, q_rot], -1).float()                           # (B, t, H, L + R)
    scores = torch.einsum("bthd,bsd->bhts", q, cache.float()) * scale
    mask = torch.arange(s_len, device=q.device)[None, :] <= positions[:, None]
    w = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bhts,bsd->bthd", w, cache[..., :lat].float())
    return out.to(q_lat.dtype)


def mla_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor,
                  k_pe: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  cache: torch.Tensor, pos, scale: float) -> torch.Tensor:
    """See mla_attention_reference.

    CUDA: csrc/mla_attention.cu, one launch, t = 1 (the decode step), L =
    512 and R = 64 (DeepSeek-V2 and V3's widths); bf16, q_lat, c_kv and
    the cache dense and 16-byte aligned; q_pe (B, 1, H, 64) and k_pe (B,
    1, 64) may be strided views with dense rope vectors (columns of the
    fused q|kv_a projection). The weights go into P·V rounded to bf16
    (their sum taken of the rounded values), the plain version keeps
    them in f32. CPU: the plain version."""
    if q_lat.device.type == "cpu":
        return mla_attention_reference(q_lat, q_pe, c_kv, k_pe, cos, sin, cache, pos, scale)
    bf16, f32 = torch.bfloat16, torch.float32
    _check_cuda("mla_attention", {"q_lat": q_lat, "c_kv": c_kv, "cache": cache, "cos": cos,
                                  "sin": sin},
                {"q_lat": bf16, "c_kv": bf16, "cache": bf16, "cos": f32, "sin": f32}, align=16)
    _check_cuda("mla_attention", {"q_pe": q_pe, "k_pe": k_pe}, {"q_pe": bf16, "k_pe": bf16},
                align=4, contiguous=False)
    b, t, h, lat = q_lat.shape
    s_len = cache.shape[1]
    if (t != 1 or lat != LATENT or q_pe.shape != (b, 1, h, ROPE) or c_kv.shape != (b, 1, LATENT)
            or k_pe.shape != (b, 1, ROPE) or cache.shape != (b, s_len, LATENT + ROPE)
            or cos.shape != (cos.shape[0], ROPE // 2) or sin.shape != cos.shape
            or q_pe.stride(-1) != 1 or k_pe.stride(-1) != 1 or q_pe.stride(2) % 2
            or q_pe.stride(0) % 2 or k_pe.stride(0) % 2 or cos.shape[0] < s_len):
        raise ValueError(f"mla_attention: q_lat {tuple(q_lat.shape)}, q_pe {tuple(q_pe.shape)} "
                         f"{q_pe.stride()}, c_kv {tuple(c_kv.shape)}, k_pe {tuple(k_pe.shape)} "
                         f"{k_pe.stride()}, cache {tuple(cache.shape)}, tables "
                         f"{tuple(cos.shape)}: t = 1, widths {LATENT} + {ROPE}")
    pos_at, pos_i = _device_pos(pos, 1, s_len, q_lat.device)
    out = torch.empty((b, 1, h, LATENT), dtype=bf16, device=q_lat.device)
    build.launch("mla_attention", q_lat.data_ptr(), q_pe.data_ptr(), q_pe.stride(0),
                 q_pe.stride(2), c_kv.data_ptr(), k_pe.data_ptr(), k_pe.stride(0),
                 cos.data_ptr(), sin.data_ptr(), cache.data_ptr(), out.data_ptr(), b, h, s_len,
                 cos.shape[0], pos_at, pos_i, scale, _stream(q_lat.device))
    count_launch(launch_counts, "mla_attention")
    if _launch_ranks(s_len, b * -(-h // HEADS_A_BLOCK)) == WIDE_RANKS:
        mla_cluster_launch(WIDE_RANKS)
    return out
