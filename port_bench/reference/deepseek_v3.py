"""Plain float32 DeepSeek-V3-architecture decoder: the reference the
Moonlight cell's output is held to.

The equations of tests/ref_deepseek_v3.py (the published block, held
there to transformers' DeepseekV3ForCausalLM): multi-head latent
attention in the expanded form with no query LoRA, RoPE in the
modeling code's interleaved pairs, RMSNorm on the latent, sigmoid
routing whose bias selects only (top-k of s + bias, weights s[chosen] /
(Σ + 1e-20) · the routed scaling factor), SwiGLU experts and the shared
SwiGLU, the first dense layers, an untied head. Plain torch operations
in float32 with TF32 off, run teacher-forced over a prompt and the tokens
served for it, a layer at a time: the weights come from the benchmark's
own draw (`lib/deepseek_v3.py`), regenerated layer by layer, so one
layer is held in float32 at a time; the experts' work runs over every
sequence's rows at once (it is per token), the attention a sequence at a
time.

The weights are re-derived at the point the configuration's
`quantization` block states: each projection of q, kv_a, o, the dense
SwiGLU and every expert (the shared SwiGLU included) quantized to int4,
symmetric per (group of input columns, output row), in groups of `group`
(128) but the experts' down projections, whose 1408 inputs take
`expert_down_group` (64; the shared SwiGLU's 2816 likewise, in the same
boundaries); kv_b_proj and the router's weight as drawn (bf16), the
router's scores and bias f32; the head int8 per row. For the rows the
program decodes one token at a time, each quantized projection's input
is quantized to `act_bits`-bit integers per (row, group) (the W4A8
decode); the prompt's rows keep their activations. Imports nothing of
the program.

The reference routes on its own f32 scores. Given the experts a served
run chose (`given`), it follows those instead, with its own scores
weighting them: the rest of the computation is then compared without
the routing's discontinuity, which at random weights turns each
rounding a token's hidden state carries into other experts for some
tokens, and those tokens' later layers into other states.
"""

from __future__ import annotations

import math

import torch

from ..lib import deepseek_v3 as dv3


def quantize_weight(w: torch.Tensor, bits: int, group: int | None) -> torch.Tensor:
    """(N, K) (out, in) → dequantized f32: symmetric per (row, group of
    `group` input columns), or per row when group is None."""
    qmax = 2 ** (bits - 1) - 1
    n, k = w.shape
    g = group or k
    wg = w.float().reshape(n, k // g, g)
    s = (wg.abs().amax(dim=-1, keepdim=True) / qmax).clamp_min(1e-12)
    return (torch.clamp(torch.round(wg / s), -qmax, qmax) * s).reshape(n, k)


def quantize_rows(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """(M, K) → dequantized: symmetric per (row, group of `group` columns)."""
    qmax = 2 ** (bits - 1) - 1
    m, k = x.shape
    xg = x.reshape(m, k // group, group)
    s = xg.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / qmax
    return (torch.clamp(torch.round(xg / s), -qmax, qmax) * s).reshape(m, k)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The norm scales are the init's ones, so they carry no weight."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def rope_interleaved(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, d) at positions 0..T-1: the modeling code's
    apply_rotary_pos_emb, the interleaved pairs regrouped into halves,
    then rotated half-split."""
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(-1, -2).reshape(t, h, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], -1)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * emb.cos()[:, None, :] + rot * emb.sin()[:, None, :]


@torch.no_grad()
def served_logits(cfg: dict, seed: int, sequences: list[tuple[list[int], int]], device,
                  act_bits: int | None = None, routes: bool = False,
                  given: list[torch.Tensor] | None = None):
    """For each (tokens, prompt_len): the logits (T − prompt_len + 1, vocab)
    f32 at positions prompt_len − 1 … T − 1. act_bits: the decode rows'
    activation width (the configuration's when None; the control reads
    lower ones). With `routes`, also, for each sequence, the experts
    each MoE layer chose at those positions ((rows, top_k) sorted ids, in
    layer order). given: for each sequence, the experts to use, (MoE
    layers, T, top_k) ids, a row of −1 where the reference chooses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = cfg["quantization"]
    bits, group, down_group = q["body_bits"], q["group"], q["expert_down_group"]
    act_bits = act_bits or q["decode_activation_bits"]
    eps = cfg["rms_norm_eps"]
    heads, nope, rope = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"])
    lora, vd, top_k = cfg["kv_lora_rank"], cfg["v_head_dim"], cfg["num_experts_per_tok"]
    ends = dv3.ends(cfg, seed, device)
    x = torch.cat([ends["model.embed_tokens.weight"][torch.tensor(toks, device=device)].float()
                   for toks, _ in sequences])                       # every sequence's rows
    bounds = [0]
    for toks, _ in sequences:
        bounds.append(bounds[-1] + len(toks))
    decode = torch.cat([torch.arange(len(toks), device=device) >= p for toks, p in sequences])
    judged = torch.cat([torch.arange(len(toks), device=device) >= p - 1 for toks, p in sequences])
    chosen = []

    def project(h, w, g, rows):
        """h @ w.T, the decode rows' h quantized per (row, group g)."""
        return torch.where(rows[:, None], quantize_rows(h, act_bits, g), h) @ w.T

    def swiglu(h, gate, up, down, g, rows):
        a = project(h, gate, group, rows)
        return project(a * torch.sigmoid(a) * project(h, up, group, rows), down, g, rows)

    for i in range(cfg["num_hidden_layers"]):
        raw = dv3.layer(cfg, seed, i, device)
        p = f"model.layers.{i}"

        def w(name, g=group):
            return quantize_weight(raw[f"{p}.{name}.weight"], bits, g)

        wq, wkva = w("self_attn.q_proj"), w("self_attn.kv_a_proj_with_mqa")
        wo = w("self_attn.o_proj")
        kv_b = raw[f"{p}.self_attn.kv_b_proj.weight"].float()
        delta = torch.empty_like(x)
        for a, b in zip(bounds[:-1], bounds[1:]):
            t, rows = b - a, decode[a:b]
            h = rms_norm(x[a:b], eps)
            qh = project(h, wq, group, rows).view(t, heads, nope + rope)
            ckv = project(h, wkva, group, rows)
            kv = (rms_norm(ckv[:, :lora], eps) @ kv_b.T).view(t, heads, nope + vd)
            k_pe = rope_interleaved(ckv[:, lora:].reshape(t, 1, rope), cfg["rope_theta"])
            q_pe = rope_interleaved(qh[..., nope:], cfg["rope_theta"])
            qf = torch.cat([qh[..., :nope], q_pe], -1)
            kf = torch.cat([kv[..., :nope], k_pe.expand(t, heads, rope)], -1)
            s = torch.einsum("qhd,khd->hqk", qf, kf) / math.sqrt(nope + rope)
            causal = torch.ones(t, t, dtype=torch.bool, device=device).triu(1)
            att = torch.einsum("hqk,khd->qhd", s.masked_fill(causal, float("-inf")).softmax(-1),
                               kv[..., nope:])
            delta[a:b] = project(att.reshape(t, heads * vd), wo, group, rows)
            del s, att
        x = x + delta
        del delta, wq, wkva, wo
        h = rms_norm(x, eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, w("mlp.gate_proj"), w("mlp.up_proj"), w("mlp.down_proj"), group,
                           decode)
            del raw
            continue
        sc = torch.sigmoid(h @ raw[f"{p}.mlp.gate.weight"].float().T)
        pick = (sc + raw[f"{p}.mlp.gate.e_score_correction_bias"]).topk(top_k, dim=-1).indices
        if given is not None:
            g = torch.cat([rows[i - cfg["first_k_dense_replace"]] for rows in given]).to(device)
            pick = torch.where((g >= 0).all(-1, keepdim=True), g.long(), pick)
        wt = sc.gather(-1, pick)
        if cfg["norm_topk_prob"]:
            wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
        wt = wt * cfg["routed_scaling_factor"]
        if routes:
            chosen.append(pick[judged].sort(-1).values)
        y = swiglu(h, w("mlp.shared_experts.gate_proj"), w("mlp.shared_experts.up_proj"),
                   w("mlp.shared_experts.down_proj", down_group), down_group, decode)
        for e in pick.unique().tolist():
            rows, slot = (pick == e).nonzero(as_tuple=True)
            out = swiglu(h[rows], w(f"mlp.experts.{e}.gate_proj"), w(f"mlp.experts.{e}.up_proj"),
                         w(f"mlp.experts.{e}.down_proj", down_group), down_group, decode[rows])
            y.index_add_(0, rows, out * wt[rows, slot, None])
        x = x + y
        del raw, y, h
    head = quantize_weight(ends["lm_head.weight"], q["head_bits"], None)
    logits = [rms_norm(x[a + p - 1:b], eps) @ head.T
              for (a, b), (_, p) in zip(zip(bounds[:-1], bounds[1:]), sequences)]
    if not routes:
        return logits
    per_seq, at = [], 0
    for toks, p in sequences:
        n = len(toks) - p + 1
        per_seq.append([c[at:at + n] for c in chosen])
        at += n
    return logits, per_seq
