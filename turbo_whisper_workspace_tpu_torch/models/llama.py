"""Llama-architecture decoder-only LM on plain tensors.

Port of turbo_whisper_workspace_tpu/models/llama.py: GQA, RoPE
(half-split layout), RMSNorm, SwiGLU, f32 softmax and norm statistics.
Parameters are a plain dict: {"token_emb", "blocks", "norm", "lm_head"},
with "blocks" a list of one dict per layer (the JAX tree stacks them
along a leading layer axis; `models/convert.py:llama_from_jax_params`
splits it). A projection is a dense {"w"} (d_in, d_out), int8 {"w_q",
"scale"} or int4 {"w_q4", "scale4"} dict in the JAX package's layouts,
and every projection goes through `ops/quant.matmul_any`.
`params_from_hf_state_dict` loads a transformers LlamaForCausalLM state
dict into that dict, as the JAX function of that name does.

Unlike the JAX function, `forward` writes the KV cache in place: the
returned cache is the same tensors as the one passed in. Its `pos` is a
host int (the prefill) or a 0-dim int64 tensor on the model's device (a
decode step a CUDA graph replays: the RoPE rows, the cache row written
and the attention mask all come from it, as the JAX function's traced
`pos`).

The layer's work beside the projections, which XLA fuses in the JAX
program, runs as four kernels (`ops/llama_ops.py`) on the card: the
residual add with RMSNorm and, where the next projections are int4 at
m ≤ 8, the grouped int8 quantizer, whose (xq, xs) q, k and v (or gate
and up) share; RoPE with the cache write; GQA attention over the cache;
SwiGLU with the quantizer of the down projection's input. On the CPU
their plain versions compute what this module computed before them.

Projections that read one input (q, k and v; gate and up) run as one
matmul over their weights concatenated along N where `fuse_siblings`
has joined them (`TorchLlama` does so): one launch of a kernel in
place of three or two, its output split into each projection's columns
(views at m = 1; at m > 1 dense copies, which the layer's kernels take).
`models/deepseek_v3.py` runs its layers on the same plumbing:
`project_siblings`, `held`, `head_logits` and the RoPE tables of
`rope_table`; `ops/quant.py` decides which projections share a quantized
input (`w4a8_groups`) and joins the int4 siblings (`join_int4`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import llama_ops, quant

PROJECTIONS = ("q", "k", "v", "out", "gate", "up", "down")
# projections quant.quantize_tree quantizes (its default keys, less Whisper's)
QUANT_KEYS = PROJECTIONS + ("lm_head",)
# a fused projection's name → the sibling projections it joins, in column order
SIBLINGS = {"qkv": ("q", "k", "v"), "gate_up": ("gate", "up")}


@dataclass(frozen=True)
class LlamaDims:
    n_vocab: int
    d_model: int
    n_layer: int
    n_head: int
    n_kv_head: int
    d_ff: int
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_ctx: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


LLAMA_CONFIGS: dict[str, LlamaDims] = {
    # Hermes-3-Llama-3.1-8B, the reference's default LLM
    "llama-3.1-8b": LlamaDims(
        n_vocab=128256, d_model=4096, n_layer=32, n_head=32, n_kv_head=8,
        d_ff=14336,
    ),
    # DeepHermes-3-3B, the reference's smaller alternative
    "llama-3.2-3b": LlamaDims(
        n_vocab=128256, d_model=3072, n_layer=28, n_head=24, n_kv_head=8,
        d_ff=8192,
    ),
    "test-tiny": LlamaDims(
        n_vocab=512, d_model=64, n_layer=2, n_head=4, n_kv_head=2, d_ff=128,
        max_ctx=512,
    ),
}


def init_params(dims: LlamaDims, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """Random weights: projections N(0, 1)·d_in^-1/2, embedding N(0, 1)·0.02,
    norm scales 1, each drawn in f32 and cast to `dtype` (the JAX function
    casts every leaf). `quant.quantize_tree(params, bits=...)` quantizes
    them afterwards."""
    d, kv_d = dims.d_model, dims.n_kv_head * dims.head_dim

    def lin(din, dout):
        w = torch.randn(din, dout, generator=generator, device=device) * din ** -0.5
        return {"w": w.to(dtype)}

    def ones():
        return {"scale": torch.ones(d, dtype=dtype, device=device)}

    shapes = {"q": (d, d), "k": (d, kv_d), "v": (d, kv_d), "out": (d, d),
              "gate": (d, dims.d_ff), "up": (d, dims.d_ff), "down": (dims.d_ff, d)}
    blocks = []
    for _ in range(dims.n_layer):
        block = {name: lin(*shapes[name]) for name in PROJECTIONS}
        block.update(attn_norm=ones(), mlp_norm=ones())
        blocks.append(block)
    emb = torch.randn(dims.n_vocab, d, generator=generator, device=device) * 0.02
    return {
        "token_emb": emb.to(dtype),
        "blocks": blocks,
        "norm": ones(),
        "lm_head": lin(d, dims.n_vocab),
    }


def rms_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return llama_ops.rms_norm_reference(x, p["scale"], eps)


def _rope_tables(positions: torch.Tensor, half: int, theta: float):
    """(cos, sin), each (1, T, 1, half) f32. The frequencies are float64
    on the host cast to f32, and the angles are formed in f32, as the JAX
    function forms them."""
    freqs = 1.0 / (theta ** (np.arange(0, half) / half))
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(positions.device)
    angles = positions[:, None].float() * freqs[None, :]              # (T, half)
    return torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]


_ROPE_TABLES: dict = {}     # (half, theta, max_ctx, device) → (cos, sin) (max_ctx, half)


def rope_table(half: int, theta: float, max_ctx: int, device: torch.device | str):
    """_rope_tables' (cos, sin) over max_ctx positions, (max_ctx, half)
    f32, built once per (half, theta, max_ctx, device) for both families:
    no host→device copy per call, so a captured step holds none."""
    key = (half, theta, max_ctx, torch.device(device))
    if key not in _ROPE_TABLES:
        cos, sin = _rope_tables(torch.arange(max_ctx, device=device), half, theta)
        _ROPE_TABLES[key] = cos[0, :, 0], sin[0, :, 0]
    return _ROPE_TABLES[key]


def init_kv_cache(dims: LlamaDims, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu") -> dict:
    shape = (dims.n_layer, batch, max_len, dims.n_kv_head * dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fuse_siblings(params: dict) -> dict:
    """Joins each block's int4 sibling projections (SIBLINGS) in place
    (`quant.join_int4`): q, k and v into qkv, gate and up into gate_up.
    Dense, int8 and mixed blocks keep theirs. A block at a time, so
    memory peaks at one layer's siblings above the weights. The dict is
    changed, not copied: whoever holds it holds the fused blocks. Returns
    params."""
    for block in params["blocks"]:
        quant.join_int4(block, SIBLINGS)
    return params


def held(holder: dict, fused: str, siblings: dict) -> tuple:
    """The names under which `holder` holds the projections siblings[fused]:
    the fused one where `fuse_siblings` joined them, else each."""
    return (fused,) if fused in holder else siblings[fused]


def project_siblings(x: torch.Tensor, holder: dict, fused: str, siblings: dict,
                     widths: dict, act) -> list:
    """x's projections by the siblings siblings[fused] of `holder`, each
    widths[name] wide: one matmul over their fused weight, split by
    columns (views), or one matmul each. act: x's shared (xq, xs), or
    None (`quant.matmul_any`)."""
    if fused not in holder:
        return [quant.matmul_any(x, holder[n], act=act) for n in siblings[fused]]
    out = quant.matmul_any(x, holder[fused], act=act)
    return list(out.split([widths[n] for n in siblings[fused]], -1))


def head_logits(params: dict, x: torch.Tensor, delta: torch.Tensor, eps: float):
    """The final norm of the residual stream x + delta (the last layer's
    output), then the head → f32 logits."""
    _, x, _ = llama_ops.llama_norm_quant(x, params["norm"]["scale"], eps, delta)
    if "w" not in params["lm_head"]:        # int8 (or int4) quantized head
        return quant.matmul_any(x, params["lm_head"]).float()
    return x.float() @ params["lm_head"]["w"].to(params["token_emb"].dtype).float()


def forward(params: dict, dims: LlamaDims, tokens: torch.Tensor,
            kv_cache: dict | None = None, pos: int | torch.Tensor = 0):
    """tokens (B, T) → (logits (B, T, vocab) f32, cache). Logits come for
    every position, as the JAX function computes them (the prefill's
    lm_head thus runs at m = B·T). With no cache a fresh one of length T
    is used and None is returned in its place. `pos` is an int or a 0-dim
    int64 tensor on the tokens' device; positions past max_ctx raise.
    Blocks may hold fused siblings (`fuse_siblings`) or separate ones."""
    b, t = tokens.shape
    dtype = params["token_emb"].dtype
    h, kvh, dh = dims.n_head, dims.n_kv_head, dims.head_dim
    device = tokens.device
    x = params["token_emb"][tokens].to(dtype)

    use_cache = kv_cache is not None
    if not use_cache:
        kv_cache = init_kv_cache(dims, b, max_len=t, dtype=dtype, device=device)
        pos = 0
    if not torch.is_tensor(pos) and pos + t > dims.max_ctx:
        raise ValueError(f"positions up to {pos + t} exceed max_ctx {dims.max_ctx}")
    cos, sin = rope_table(dh // 2, dims.rope_theta, dims.max_ctx, device)  # every layer's
    eps, m = dims.norm_eps, b * t
    widths = {"q": h * dh, "k": kvh * dh, "v": kvh * dh, "gate": dims.d_ff, "up": dims.d_ff}

    delta = None                 # the last layer's output, added before the next norm
    for li, block in enumerate(params["blocks"]):
        ck, cv = kv_cache["k"][li], kv_cache["v"][li]                # (B, S, kvh·dh) views
        x, hnorm, act = llama_ops.llama_norm_quant(
            x, block["attn_norm"]["scale"], eps, delta,
            quant.w4a8_groups(block, held(block, "qkv", SIBLINGS), m))
        # the fused output's columns copied dense (no copy at m = 1), as
        # the layer's kernels take them
        q, k, v = (p.contiguous()
                   for p in project_siblings(hnorm, block, "qkv", SIBLINGS, widths, act))
        q, k, v = q.reshape(b, t, h, dh), k.reshape(b, t, kvh, dh), v.reshape(b, t, kvh, dh)
        # k and v written in place, at the positions' rows
        q = llama_ops.llama_rope_cache(q, k, v, ck, cv, cos, sin, pos)
        attn = llama_ops.llama_attention(q, ck, cv, pos)               # (B, t, H·dh)
        act, groups = None, quant.w4a8_groups(block, ("out",), m)
        if groups:
            act = llama_ops.llama_norm_quant(attn, None, eps, None, groups, norm=False)[2]
        delta = quant.matmul_any(attn, block["out"], act=act)

        x, hnorm, act = llama_ops.llama_norm_quant(
            x, block["mlp_norm"]["scale"], eps, delta,
            quant.w4a8_groups(block, held(block, "gate_up", SIBLINGS), m))
        gate, up = (p.contiguous()
                    for p in project_siblings(hnorm, block, "gate_up", SIBLINGS, widths, act))
        prod, act = llama_ops.llama_swiglu_quant(gate, up, quant.w4a8_groups(block, ("down",), m))
        delta = quant.matmul_any(prod, block["down"], act=act)

    return head_logits(params, x, delta, eps), (kv_cache if use_cache else None)


def params_from_hf_state_dict(sd: dict, dims: LlamaDims,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cpu") -> dict:
    """The port's Llama parameter dict from a transformers
    LlamaForCausalLM state dict: weights to f32, (out, in) transposed to
    (in, out), then cast to `dtype` (the same roundings as the JAX
    loader). A tied head reads the embedding."""
    def t(name, transpose=False):
        x = sd[name].detach().to(torch.float32).cpu()
        x = x.T if transpose else x
        return x.contiguous().to(device=device, dtype=dtype)

    blocks = []
    for i in range(dims.n_layer):
        p = f"model.layers.{i}"
        blocks.append({
            "attn_norm": {"scale": t(f"{p}.input_layernorm.weight")},
            "q": {"w": t(f"{p}.self_attn.q_proj.weight", True)},
            "k": {"w": t(f"{p}.self_attn.k_proj.weight", True)},
            "v": {"w": t(f"{p}.self_attn.v_proj.weight", True)},
            "out": {"w": t(f"{p}.self_attn.o_proj.weight", True)},
            "mlp_norm": {"scale": t(f"{p}.post_attention_layernorm.weight")},
            "gate": {"w": t(f"{p}.mlp.gate_proj.weight", True)},
            "up": {"w": t(f"{p}.mlp.up_proj.weight", True)},
            "down": {"w": t(f"{p}.mlp.down_proj.weight", True)},
        })
    head_key = "lm_head.weight" if "lm_head.weight" in sd else "model.embed_tokens.weight"
    return {
        "token_emb": t("model.embed_tokens.weight"),
        "blocks": blocks,
        "norm": {"scale": t("model.norm.weight")},
        "lm_head": {"w": t(head_key, True)},
    }
