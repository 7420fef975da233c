"""Weights from the JAX package's parameter tree and `.npz` checkpoints.

Port of turbo_whisper_workspace_tpu/models/convert.py (load_params), plus
`from_jax_params`, which maps the JAX tree onto models/whisper.Whisper:

* `blocks` leaves are stacked along a leading layer axis (L, ...) and
  are split into one module per layer;
* linear weights `w` are stored (d_in, d_out) and become
  `nn.Linear.weight` (d_out, d_in);
* conv weights are OIH, which is torch's conv1d layout, and copy as is;
* LayerNorm `scale`/`bias` become `weight`/`bias`.

One checkpoint thus feeds both packages. The Whisper HF snapshot loader
waits for a later slice.

For the Llama LM (models/llama.py): `llama_from_jax_params` takes the JAX
tree, dense or already quantized, and `params_from_hf_state_dict` (port
of turbo_whisper_workspace_tpu/models/llama.py:params_from_hf_state_dict)
a transformers LlamaForCausalLM state dict. Both keep the JAX layouts:
(d_in, d_out) weights, (K, N) int8, (K/2, N) packed int4, (K/G, N) f32
scales, one dict per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaDims
from .whisper import Whisper, WhisperDims


def _leaf_name(parts: list[str], arr: np.ndarray) -> tuple[str, bool]:
    """JAX leaf path → (torch parameter path, transpose?)."""
    *mods, leaf = parts
    if leaf == "w":
        # conv weights are 3-D (OIH) and keep their layout
        return ".".join(mods + ["weight"]), arr.ndim == 2
    if leaf == "b":
        return ".".join(mods + ["bias"]), False
    if leaf == "scale":
        return ".".join(mods + ["weight"]), False
    return ".".join(mods + [leaf]), False


def _flatten(tree: dict, prefix: tuple = ()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _flatten(node, prefix + (key,))
        else:
            yield list(prefix + (key,)), np.array(node, dtype=np.float32)


def state_dict_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) → Whisper state dict."""
    state = {}
    for parts, arr in _flatten(params):
        if len(parts) > 2 and parts[1] == "blocks":
            # (L, ...) stacked leaf → one entry per layer
            head, rest = parts[:2], parts[2:]
            for li in range(arr.shape[0]):
                name, transpose = _leaf_name(head + [str(li)] + rest, arr[li])
                state[name] = torch.from_numpy(arr[li].T.copy() if transpose else arr[li])
        else:
            name, transpose = _leaf_name(parts, arr)
            state[name] = torch.from_numpy(arr.T.copy() if transpose else arr)
    return state


def from_jax_params(params: dict, dims: WhisperDims,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> Whisper:
    """A Whisper module holding the weights of a JAX parameter tree."""
    with torch.device("meta"):
        model = Whisper(dims)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def load_params(path: str) -> dict:
    """Load a flat `.npz` checkpoint (keys like `encoder/blocks/attn/q/w`,
    bf16 stored as f32) into a nested tree of numpy arrays, skipping
    `__meta__`."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__meta__":
                continue
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


# ---------------------------------------------------------------------------
# Llama

_QUANT_SCALES = ("scale", "scale4")


def llama_from_jax_params(params: dict, dims: LlamaDims,
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cpu") -> dict:
    """The port's Llama parameter dict from a JAX tree (numpy or JAX
    arrays; layer-stacked `blocks`). Integer payloads (`w_q`, `w_q4`) and
    the f32 scales of quantized projections carry over byte for byte;
    every other leaf is cast to `dtype`."""
    def leaf(node, keep_f32: bool):
        arr = np.asarray(node)
        if arr.dtype.kind in "iu":
            return torch.from_numpy(arr.copy()).to(device)
        t = torch.from_numpy(np.array(node, dtype=np.float32)).to(device)
        return t if keep_f32 else t.to(dtype)

    def convert(node: dict) -> dict:
        quantized = "w_q" in node or "w_q4" in node
        return {k: convert(v) if isinstance(v, dict)
                else leaf(v, quantized and k in _QUANT_SCALES) for k, v in node.items()}

    tree = convert({k: v for k, v in params.items() if k != "blocks"})
    stacked = convert(params["blocks"])
    tree["blocks"] = [
        {name: {k: v[li] for k, v in proj.items()} for name, proj in stacked.items()}
        for li in range(dims.n_layer)]
    return tree


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
