"""The DeepSeek-V3-architecture configuration's weights and FLOPs.

Weights: random, drawn on the card from the run's seed one layer at a
time, in transformers' DeepseekV3ForCausalLM layout (weights (out, in),
the rope columns of q_proj and kv_a_proj_with_mqa in the modeling code's
interleaved pairs, one tensor a routed expert, the shared experts as one
SwiGLU n_shared · moe_intermediate_size wide): the layout a published
checkpoint has, which the program loads with its own loader
(models/deepseek_v3.py:block_from_hf) and the reference reads as it is.
The distributions are weights.py's (linear weights N(0, 1/d_in), unit
norm scales, embedding N(0, 0.02²)); the router's selection bias, which
no init gives, is the configuration's `assumed` draw. Each layer is one
bf16 draw cut into views (lib/weights.py: `draw`), so the same seed gives
the same tensors bit for bit and the reference redraws its own copy.
"""

from __future__ import annotations

import torch

from . import weights

BIAS_KEY = "e_score_correction_bias"


def bias_std(cfg: dict) -> float:
    return float(cfg["assumed"]["e_score_correction_bias_std"])


def layer(cfg: dict, seed: int, i: int, device) -> dict[str, torch.Tensor]:
    """Layer i's tensors {HF name: tensor}, bf16 but the router's bias
    (f32); norm scales are ones."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    lora = cfg["kv_lora_rank"]
    p = f"model.layers.{i}"

    def lin(name, out, inp):
        return (f"{p}.{name}", (out, inp), inp ** -0.5)

    leaves = [lin("self_attn.q_proj.weight", heads * (nope + rope), d),
              lin("self_attn.kv_a_proj_with_mqa.weight", lora + rope, d),
              lin("self_attn.kv_b_proj.weight", heads * (nope + vd), lora),
              lin("self_attn.o_proj.weight", d, heads * vd)]
    ones = [("input_layernorm.weight", d), ("post_attention_layernorm.weight", d),
            ("self_attn.kv_a_layernorm.weight", lora)]
    moe = i >= cfg["first_k_dense_replace"]
    if not moe:
        ff = cfg["intermediate_size"]
        leaves += [lin("mlp.gate_proj.weight", ff, d), lin("mlp.up_proj.weight", ff, d),
                   lin("mlp.down_proj.weight", d, ff)]
    else:
        f, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
        fs = f * cfg["n_shared_experts"]
        leaves += [lin("mlp.gate.weight", e, d), (f"{p}.mlp.gate.{BIAS_KEY}", (e,), bias_std(cfg))]
        for j in range(e):
            leaves += [lin(f"mlp.experts.{j}.gate_proj.weight", f, d),
                       lin(f"mlp.experts.{j}.up_proj.weight", f, d),
                       lin(f"mlp.experts.{j}.down_proj.weight", d, f)]
        leaves += [lin("mlp.shared_experts.gate_proj.weight", fs, d),
                   lin("mlp.shared_experts.up_proj.weight", fs, d),
                   lin("mlp.shared_experts.down_proj.weight", d, fs)]
    out = weights.draw(leaves, weights.generator(seed, i + 1, device), device)
    if moe:
        out[f"{p}.mlp.gate.{BIAS_KEY}"] = out[f"{p}.mlp.gate.{BIAS_KEY}"].float()
    for name, n in ones:
        out[f"{p}.{name}"] = torch.ones(n, dtype=weights.DTYPE, device=device)
    return out


def ends(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The token embedding (vocab, d) and the output head (vocab, d), bf16."""
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    return weights.draw([("model.embed_tokens.weight", (vocab, d), 0.02),
                         ("lm_head.weight", (vocab, d), d ** -0.5)],
                        weights.generator(seed, 0, device), device)


def token_flops(cfg: dict, pos: int) -> float:
    """Model FLOPs of one token at position `pos` through the body: 2 per
    active parameter (the projections, kv_b as the expanded form's k_nope
    and v, the router, the dense layer or the top-k and shared experts)
    and the attention at qk nope + rope and v head dims over pos + 1
    keys; the absorbed form's extra work is not counted."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    lora, layers = cfg["kv_lora_rank"], cfg["num_hidden_layers"]
    attn = (d * heads * (nope + rope) + d * (lora + rope) + lora * heads * (nope + vd)
            + heads * vd * d)
    dense = 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"]
           + 3 * d * f * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]))
    first = cfg["first_k_dense_replace"]
    params = layers * attn + first * dense + (layers - first) * moe
    return 2.0 * params + layers * 2.0 * heads * (nope + rope + vd) * (pos + 1)


def generate_flops(cfg: dict, prompt: int, forwards: int) -> float:
    """A prefill of `prompt` tokens, then `forwards` decode steps; logits
    of the last prompt position and of each step."""
    body = sum(token_flops(cfg, p) for p in range(prompt + forwards))
    return body + (forwards + 1) * 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
