"""Plain float32 Llama-architecture decoder: the reference the enrichment
cell's output is held to.

The published architecture (RMSNorm, grouped-query attention, half-split
RoPE, SwiGLU, an untied output head) in plain torch operations with TF32
off, run teacher-forced over a prompt and the tokens served for it. The
weights are re-derived at the point the configuration states: each body
projection quantized to int4, symmetric per (group of `group` input rows,
column); the head to int8, symmetric per column; and, for the rows the
program decodes one token at a time, each body projection's input
quantized to `act_bits`-bit integers per (row, group) (the W4A8 decode;
the prompt's rows keep their activations). The weights come from the
benchmark's own draw (`lib/weights.py`), regenerated layer by layer, so
only one layer is held in float32 at a time. Imports nothing of the port.
"""

from __future__ import annotations

import math

import torch

from ..lib import weights


def quantize_weight(w: torch.Tensor, bits: int, group: int | None) -> torch.Tensor:
    """(K, N) → dequantized f32: symmetric per (group of rows, column), or
    per column when group is None."""
    qmax = 2 ** (bits - 1) - 1
    k, n = w.shape
    g = group or k
    wg = w.float().reshape(k // g, g, n)
    s = (wg.abs().amax(dim=1, keepdim=True) / qmax).clamp_min(1e-12)
    return (torch.clamp(torch.round(wg / s), -qmax, qmax) * s).reshape(k, n)


def quantize_rows(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """(M, K) → dequantized: symmetric per (row, group of `group` columns)."""
    qmax = 2 ** (bits - 1) - 1
    m, k = x.shape
    xg = x.reshape(m, k // group, group)
    s = xg.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / qmax
    return (torch.clamp(torch.round(xg / s), -qmax, qmax) * s).reshape(m, k)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, Dh) at positions 0..T-1, half-split rotation."""
    t, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(t, dtype=torch.float64)[:, None] * freqs[None, :]
    cos, sin = (f(ang).float().to(x.device)[:, None, :] for f in (torch.cos, torch.sin))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@torch.no_grad()
def served_logits(cfg: dict, seed: int, sequences: list[tuple[list[int], int]], device,
                  act_bits: int | None = None) -> list[torch.Tensor]:
    """For each (tokens, prompt_len): the logits (T − prompt_len + 1, vocab)
    f32 at positions prompt_len − 1 … T − 1, i.e. of each token the
    program generated after the prompt, and of the one after the last.
    act_bits: the decode rows' activation width (the configuration's
    when None; the control reads lower ones). Norm scales are the init's
    ones, so the norms carry no weight."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = cfg["quantization"]
    group, eps = q["group"], cfg["rms_norm_eps"]
    act_bits = act_bits or q["decode_activation_bits"]
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    kv_heads = cfg["num_key_value_heads"]
    dh = d // heads
    ends = weights.llama_ends(cfg, seed, device)
    xs = [ends["token_emb"][torch.tensor(toks, device=device)].float() for toks, _ in sequences]
    decode_rows = [torch.arange(len(toks), device=device) >= p for toks, p in sequences]

    def project(x, w, rows):
        x = torch.where(rows[:, None], quantize_rows(x, act_bits, group), x)
        return x @ w

    for layer in range(cfg["num_hidden_layers"]):
        raw = weights.llama_layer(cfg, seed, layer, device)
        w = {name: quantize_weight(t, q["body_bits"], group) for name, t in raw.items()}
        del raw
        for i, x in enumerate(xs):
            t = x.shape[0]
            rows = decode_rows[i]
            h = rms_norm(x, eps)
            qh = rope(project(h, w["q"], rows).view(t, heads, dh), cfg["rope_theta"])
            kh = rope(project(h, w["k"], rows).view(t, kv_heads, dh), cfg["rope_theta"])
            vh = project(h, w["v"], rows).view(t, kv_heads, dh)
            rep = heads // kv_heads
            kh, vh = kh.repeat_interleave(rep, 1), vh.repeat_interleave(rep, 1)
            s = torch.einsum("qhd,khd->hqk", qh, kh) / math.sqrt(dh)
            causal = torch.ones(t, t, dtype=torch.bool, device=device).triu(1)
            a = torch.einsum("hqk,khd->qhd", s.masked_fill(causal, float("-inf")).softmax(-1), vh)
            x = x + project(a.reshape(t, d), w["out"], rows)
            h = rms_norm(x, eps)
            gate, up = project(h, w["gate"], rows), project(h, w["up"], rows)
            xs[i] = x + project(gate * torch.sigmoid(gate) * up, w["down"], rows)
        del w
    head = quantize_weight(ends["lm_head"], q["head_bits"], None)
    return [rms_norm(x[p - 1:], eps) @ head for x, (_, p) in zip(xs, sequences)]
