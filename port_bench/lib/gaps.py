"""Summaries of the per-token gaps a check reads: at each compared
position, by how much the reference's best token beats the one judged
(0 where they agree)."""

from __future__ import annotations

import torch


def summary(gaps: list[torch.Tensor]) -> dict:
    """max (the widest gap), mean, p99 and the share of positions where
    the reference puts another token first, over all positions."""
    g = torch.cat([x.flatten().float().cpu() for x in gaps]) if gaps else torch.zeros(1)
    g = torch.nan_to_num(g, nan=float("inf"))
    finite = g[torch.isfinite(g)]
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(finite, 0.99)) if len(finite) else float("inf"),
            "disagree": float((g > 0).float().mean()), "tokens": int(g.numel())}
