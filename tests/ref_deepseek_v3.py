"""Plain float32 DeepSeek-V3 decoder (Moonlight-16B-A3B's architecture):
the reference the port's `models/deepseek_v3.py` is held to.

The published equations in plain torch operations, with TF32 off, no
cache, no kernels and no batching, on a transformers
`DeepseekV3ForCausalLM` state dict (weights (out, in)):

* multi-head latent attention (DeepSeek-V2, arXiv:2405.04434, §2.1) with
  no query LoRA: q = x W_q split into 128 "nope" and 64 rope dims a
  head; [c_kv, k_pe] = x W_kv_a; c_kv = RMSNorm(c_kv); per head
  [k_nope, v] = c_kv W_kv_b; RoPE on q_pe and the one k_pe every head
  shares, in the interleaved pairs of DeepSeek-V3's modeling code
  (`apply_rotary_pos_emb` views each rope vector as (d/2, 2) pairs);
  scores (q_nope·k_nope + q_pe·k_pe) · (nope + rope)^-1/2, causal mask,
  softmax, o = Σ p v, then W_o. The expanded form, as the modeling code
  computes it;
* sigmoid routing with a bias used for selection only (DeepSeek-V3,
  arXiv:2412.19437, §2.1.2): s = sigmoid(x W_g) in f32, the top-k of
  s + bias chosen, weights s[chosen] / (Σ s[chosen] + 1e-20) · the
  routed scaling factor (the modeling code's `norm_topk_prob` and its
  1e-20); y = Σ w_i E_i(x) + Shared(x), SwiGLU experts;
* RMSNorm (eps from the config), residual blocks, the first
  `first_k_dense_replace` layers dense, an untied head.

Departures: n_group / topk_group are 1 in every config this repository
runs, so group-limited routing is not written out (a config with more
groups raises); no rope scaling (YaRN) for the same reason. Imports
nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, d) at `positions`: DeepSeek-V3's apply_rotary_pos_emb,
    which first regroups each vector's interleaved pairs (x0, x1), (x2,
    x3), ... into halves, then rotates half-split by frequency i."""
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(-1, -2).reshape(t, h, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], -1)
    cos, sin = emb.cos()[:, None, :], emb.sin()[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    """SwiGLU with (out, in) weights."""
    g = x @ gate.T
    return (g * torch.sigmoid(g) * (x @ up.T)) @ down.T


def route(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, cfg: dict):
    """(chosen (T, k) expert ids, their weights (T, k) f32)."""
    if cfg.get("n_group", 1) != 1 or cfg.get("topk_group", 1) != 1:
        raise ValueError("group-limited routing is not written out")
    s = torch.sigmoid(h.float() @ weight.float().T)
    chosen = (s + bias.float()).topk(cfg["num_experts_per_tok"], dim=-1).indices
    w = s.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return chosen, w * cfg["routed_scaling_factor"]


def moe(h: torch.Tensor, sd: dict, p: str, cfg: dict) -> torch.Tensor:
    chosen, w = route(h, sd[f"{p}.gate.weight"], sd[f"{p}.gate.e_score_correction_bias"], cfg)
    y = torch.zeros_like(h)
    for e in chosen.unique().tolist():
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        out = swiglu(h[rows], *(sd[f"{p}.experts.{e}.{n}_proj.weight"]
                                for n in ("gate", "up", "down")))
        y.index_add_(0, rows, out * w[rows, slot, None])
    return y + swiglu(h, *(sd[f"{p}.shared_experts.{n}_proj.weight"]
                           for n in ("gate", "up", "down")))


def attention(h: torch.Tensor, sd: dict, p: str, cfg: dict) -> torch.Tensor:
    t = h.shape[0]
    heads, nope, rope = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"])
    lora, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    positions = torch.arange(t)
    q = (h @ sd[f"{p}.q_proj.weight"].T).view(t, heads, nope + rope)
    ckv = h @ sd[f"{p}.kv_a_proj_with_mqa.weight"].T
    c, k_pe = ckv[:, :lora], ckv[:, lora:].view(t, 1, rope)
    c = rms_norm(c, sd[f"{p}.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = (c @ sd[f"{p}.kv_b_proj.weight"].T).view(t, heads, nope + vd)
    q_pe = rope_interleaved(q[..., nope:], positions, cfg["rope_theta"])
    k_pe = rope_interleaved(k_pe, positions, cfg["rope_theta"]).expand(t, heads, rope)
    qf = torch.cat([q[..., :nope], q_pe], -1)
    kf = torch.cat([kv[..., :nope], k_pe], -1)
    s = torch.einsum("qhd,khd->hqk", qf, kf) * (nope + rope) ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool).triu(1)
    a = torch.einsum("hqk,khd->qhd", s.masked_fill(causal, float("-inf")).softmax(-1),
                     kv[..., nope:])
    return a.reshape(t, heads * vd) @ sd[f"{p}.o_proj.weight"].T


@torch.no_grad()
def forward(sd: dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (T,) int64 → logits (T, vocab) f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = {k: v.detach().float().cpu() for k, v in sd.items()}
    eps = cfg["rms_norm_eps"]
    x = sd["model.embed_tokens.weight"][tokens.cpu()]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        x = x + attention(rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps), sd,
                          f"{p}.self_attn", cfg)
        h = rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
        if i >= cfg["first_k_dense_replace"]:
            x = x + moe(h, sd, f"{p}.mlp", cfg)
        else:
            x = x + swiglu(h, *(sd[f"{p}.mlp.{n}_proj.weight"] for n in ("gate", "up", "down")))
    return rms_norm(x, sd["model.norm.weight"], eps) @ sd["lm_head.weight"].T


def routing(sd: dict, cfg: dict, tokens: torch.Tensor) -> list[torch.Tensor]:
    """The chosen experts (T, k) of every MoE layer, in layer order, over
    the forward of `tokens` (sorted ids a row)."""
    out = []
    original = globals()["route"]

    def recording(h, weight, bias, cfg_):
        chosen, w = original(h, weight, bias, cfg_)
        out.append(chosen.sort(-1).values)
        return chosen, w

    globals()["route"] = recording
    try:
        forward(sd, cfg, tokens)
    finally:
        globals()["route"] = original
    return out


def random_state_dict(cfg: dict, generator: torch.Generator, bias_std: float = 0.0) -> dict:
    """A DeepseekV3ForCausalLM state dict of N(0, 1/d_in) projections,
    N(0, 0.02²) embedding, norm scales drawn near 1 (so a loader that
    drops one shows) and a selection bias N(0, bias_std²)."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    lora, e, f = cfg["kv_lora_rank"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]

    def lin(out, inp):
        return torch.randn(out, inp, generator=generator) * inp ** -0.5

    def norm(n):
        return 1.0 + 0.1 * torch.randn(n, generator=generator)

    sd = {"model.embed_tokens.weight": torch.randn(cfg["vocab_size"], d,
                                                   generator=generator) * 0.02,
          "model.norm.weight": norm(d), "lm_head.weight": lin(cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        sd.update({
            f"{p}.input_layernorm.weight": norm(d),
            f"{p}.post_attention_layernorm.weight": norm(d),
            f"{p}.self_attn.q_proj.weight": lin(heads * (nope + rope), d),
            f"{p}.self_attn.kv_a_proj_with_mqa.weight": lin(lora + rope, d),
            f"{p}.self_attn.kv_a_layernorm.weight": norm(lora),
            f"{p}.self_attn.kv_b_proj.weight": lin(heads * (nope + vd), lora),
            f"{p}.self_attn.o_proj.weight": lin(d, heads * vd),
        })
        if i < cfg["first_k_dense_replace"]:
            ff = cfg["intermediate_size"]
            sd.update({f"{p}.mlp.gate_proj.weight": lin(ff, d),
                       f"{p}.mlp.up_proj.weight": lin(ff, d),
                       f"{p}.mlp.down_proj.weight": lin(d, ff)})
            continue
        sd[f"{p}.mlp.gate.weight"] = lin(e, d)
        sd[f"{p}.mlp.gate.e_score_correction_bias"] = torch.randn(
            e, generator=generator) * bias_std
        for j in range(e):
            sd.update({f"{p}.mlp.experts.{j}.gate_proj.weight": lin(f, d),
                       f"{p}.mlp.experts.{j}.up_proj.weight": lin(f, d),
                       f"{p}.mlp.experts.{j}.down_proj.weight": lin(d, f)})
        fs = f * cfg["n_shared_experts"]
        sd.update({f"{p}.mlp.shared_experts.gate_proj.weight": lin(fs, d),
                   f"{p}.mlp.shared_experts.up_proj.weight": lin(fs, d),
                   f"{p}.mlp.shared_experts.down_proj.weight": lin(d, fs)})
    return sd
