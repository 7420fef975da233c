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


def _rope_table(dims: LlamaDims, device: torch.device):
    """_rope_tables' (cos, sin) over max_ctx positions, (max_ctx, half)
    f32, built once per (dims, device): no host→device copy per call, so
    a captured step holds none."""
    half = dims.head_dim // 2
    key = (half, dims.rope_theta, dims.max_ctx, torch.device(device))
    if key not in _ROPE_TABLES:
        cos, sin = _rope_tables(torch.arange(dims.max_ctx, device=device), half,
                                dims.rope_theta)
        _ROPE_TABLES[key] = cos[0, :, 0], sin[0, :, 0]
    return _ROPE_TABLES[key]


def _rope_rows(dims: LlamaDims, positions: torch.Tensor):
    """_rope_tables' (cos, sin) at `positions` (T,) on their device, as
    rows of _rope_table's tables."""
    return tuple(t.index_select(0, positions)[None, :, None, :]
                 for t in _rope_table(dims, positions.device))


_apply_rope = llama_ops.apply_rope


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, Dh), positions (T,) → rotated (Llama half-split layout)."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1] // 2, theta))


def init_kv_cache(dims: LlamaDims, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu") -> dict:
    shape = (dims.n_layer, batch, max_len, dims.n_kv_head * dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fuse_siblings(params: dict) -> dict:
    """Joins each block's sibling projections (SIBLINGS) in place, where
    all of them are int4 {"w_q4", "scale4"} of one K and one group count:
    the block gets {"w_q4" (K/2, ΣN), "scale4" (K/G, ΣN)}, their columns
    side by side, under the fused name and loses the separate ones. Dense,
    int8 and mixed blocks keep theirs. A block at a time, so memory peaks
    at one layer's siblings above the weights. The dict is changed, not
    copied: whoever holds it holds the fused blocks. Returns params."""
    for block in params["blocks"]:
        for fused, names in SIBLINGS.items():
            parts = [block.get(n) for n in names]
            if not all(p is not None and set(p) == {"w_q4", "scale4"} and p["w_q4"].ndim == 2
                       for p in parts):
                continue
            if len({(p["w_q4"].shape[0], p["scale4"].shape[0]) for p in parts}) != 1:
                continue
            block[fused] = {key: torch.cat([p[key] for p in parts], dim=1)
                            for key in ("w_q4", "scale4")}
            for n in names:
                del block[n]
    return params


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
    cos, sin = _rope_table(dims, device)                # shared by every layer
    eps = dims.norm_eps

    def groups(block: dict, names: tuple) -> int:
        """The groups of the int4 projections `names`, which share one
        quantized input at m ≤ 8; 0 where they take x itself (m > 8, or
        another weight format)."""
        kinds = {block[n]["scale4"].shape[0] if "w_q4" in block[n] else 0 for n in names}
        return kinds.pop() if b * t <= 8 and len(kinds) == 1 else 0

    def project(x: torch.Tensor, wp: dict, act) -> torch.Tensor:
        return quant.matmul_any(x, wp) if act is None else quant.matmul_any(x, wp, act=act)

    widths = {"q": h * dh, "k": kvh * dh, "v": kvh * dh, "gate": dims.d_ff, "up": dims.d_ff}

    def held(block: dict, fused: str) -> tuple:
        """The names the block holds the siblings `fused` joins under."""
        return (fused,) if fused in block else SIBLINGS[fused]

    def project_siblings(x: torch.Tensor, block: dict, fused: str, act) -> list:
        """The sibling projections of x: one matmul over the fused weight,
        split by columns (at m = 1 dense views, copied by nothing), or one
        matmul each."""
        if fused not in block:
            return [project(x, block[n], act) for n in SIBLINGS[fused]]
        parts = project(x, block[fused], act).split([widths[n] for n in SIBLINGS[fused]], -1)
        return [p.contiguous() for p in parts]

    delta = None                 # the last layer's output, added before the next norm
    for li, block in enumerate(params["blocks"]):
        ck, cv = kv_cache["k"][li], kv_cache["v"][li]                # (B, S, kvh·dh) views
        x, hnorm, act = llama_ops.llama_norm_quant(x, block["attn_norm"]["scale"], eps, delta,
                                                   groups(block, held(block, "qkv")))
        q, k, v = project_siblings(hnorm, block, "qkv", act)
        q, k, v = q.reshape(b, t, h, dh), k.reshape(b, t, kvh, dh), v.reshape(b, t, kvh, dh)
        # k and v written in place, at the positions' rows
        q = llama_ops.llama_rope_cache(q, k, v, ck, cv, cos, sin, pos)
        attn = llama_ops.llama_attention(q, ck, cv, pos)               # (B, t, H·dh)
        act = None
        if groups(block, ("out",)):
            act = llama_ops.llama_norm_quant(attn, None, eps, None, groups(block, ("out",)),
                                             norm=False)[2]
        delta = project(attn, block["out"], act)

        x, hnorm, act = llama_ops.llama_norm_quant(x, block["mlp_norm"]["scale"], eps, delta,
                                                   groups(block, held(block, "gate_up")))
        gate, up = project_siblings(hnorm, block, "gate_up", act)
        prod, act = llama_ops.llama_swiglu_quant(gate, up, groups(block, ("down",)))
        delta = project(prod, block["down"], act)

    _, x, _ = llama_ops.llama_norm_quant(x, params["norm"]["scale"], eps, delta)
    if "w" not in params["lm_head"]:        # int8 (or int4) quantized head
        logits = quant.matmul_any(x, params["lm_head"]).float()
    else:
        logits = x.float() @ params["lm_head"]["w"].to(dtype).float()
    return logits, (kv_cache if use_cache else None)


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
