"""Weights from the JAX package's parameter tree, `.npz` checkpoints and
HF Whisper snapshots.

Port of turbo_whisper_workspace_tpu/models/convert.py (`save_params`,
`load_params`, `load_meta`, `hf_config_from_dims`, `dims_from_hf_config`,
`params_from_hf_state_dict`, `load_hf_snapshot`, `save_checkpoint`,
`load_checkpoint`), plus the functions that
map a JAX tree onto the port's modules: `from_jax_params` (Whisper),
`segmentation_from_jax_params` and `embedding_from_jax_params` (the
diarization nets), and `jax_params_from_module`, the way back:

* `blocks` leaves, at any depth of the tree (`encoder/blocks` in
  Whisper's, top-level `blocks` in the diarization nets'), are stacked
  along a leading layer axis (L, ...) and are split into one module per
  layer;
* linear weights `w` are stored (d_in, d_out) and become
  `nn.Linear.weight` (d_out, d_in);
* conv weights are OIH, which is torch's conv1d layout, and copy as is;
* LayerNorm `scale`/`bias` become `weight`/`bias`.

One checkpoint thus feeds both packages: `save_params` writes the JAX
package's flat `.npz` (bf16 stored as f32, `__meta__` as JSON), which
either package's `load_params` reads. `save_checkpoint` /
`load_checkpoint` differ from the JAX package's: it writes Orbax
checkpoint directories, and here a checkpoint is one `torch.save` file
of the nested tensor tree, read back with `weights_only=True`; the two
are not interchangeable, and the `.npz` stays the interchange format. A
transformers
WhisperForConditionalGeneration state dict goes through the JAX tree's
layout too (`params_from_hf_state_dict`), so both packages round its
weights alike; `load_hf_snapshot` reads a snapshot directory
(`config.json` with `model.safetensors` or `pytorch_model.bin`).

For the Llama LM: `llama_from_jax_params` takes the JAX tree, dense or
already quantized, keeping the JAX layouts: (d_in, d_out) weights, (K, N)
int8, (K/2, N) packed int4, (K/G, N) f32 scales, one dict per layer.
The transformers LlamaForCausalLM loader is
models/llama.py:params_from_hf_state_dict, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from torch import nn

from .embedding import Embedding, EmbeddingDims
from .llama import LlamaDims
from .segmentation import Segmentation, SegmentationDims
from .whisper import LayerNorm, Whisper, WhisperDims


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


def _f32(node) -> np.ndarray:
    """A leaf (numpy, JAX or torch array, bf16 too) → f32 numpy."""
    if isinstance(node, torch.Tensor):
        return node.detach().to(torch.float32).cpu().numpy()
    return np.array(node, dtype=np.float32)


def _flatten(tree: dict, prefix: tuple = ()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _flatten(node, prefix + (key,))
        else:
            yield list(prefix + (key,)), _f32(node)


def state_dict_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) → state dict of the
    matching port module."""
    state = {}
    for parts, arr in _flatten(params):
        if "blocks" in parts[:-1]:
            # (L, ...) stacked leaf → one entry per layer
            cut = parts.index("blocks") + 1
            head, rest = parts[:cut], parts[cut:]
            for li in range(arr.shape[0]):
                name, transpose = _leaf_name(head + [str(li)] + rest, arr[li])
                state[name] = torch.from_numpy(arr[li].T.copy() if transpose else arr[li])
        else:
            name, transpose = _leaf_name(parts, arr)
            state[name] = torch.from_numpy(arr.T.copy() if transpose else arr)
    return state


def _module_from_jax_params(cls, params: dict, dims, dtype: torch.dtype,
                            device: torch.device | str) -> nn.Module:
    with torch.device("meta"):
        model = cls(dims)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def from_jax_params(params: dict, dims: WhisperDims,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> Whisper:
    """A Whisper module holding the weights of a JAX parameter tree."""
    return _module_from_jax_params(Whisper, params, dims, dtype, device)


def segmentation_from_jax_params(params: dict, dims: SegmentationDims,
                                 dtype: torch.dtype = torch.float32,
                                 device: torch.device | str = "cpu") -> Segmentation:
    """A Segmentation module holding the weights of a JAX
    models/segmentation.py tree (its `pos_emb` is a leaf and is copied)."""
    return _module_from_jax_params(Segmentation, params, dims, dtype, device)


def embedding_from_jax_params(params: dict, dims: EmbeddingDims,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cpu") -> Embedding:
    """An Embedding module holding the weights of a JAX
    models/embedding.py tree."""
    return _module_from_jax_params(Embedding, params, dims, dtype, device)


def jax_params_from_module(model: nn.Module) -> dict:
    """A port module (Whisper, Segmentation, Embedding) → the JAX
    package's parameter tree of f32 numpy arrays: the inverse of the
    `*_from_jax_params` functions (layers stacked under `blocks`,
    (d_in, d_out) linear weights, LayerNorm `scale`)."""
    owners = dict(model.named_modules())
    flat: dict[tuple, dict[int, np.ndarray]] = {}
    for name, tensor in model.state_dict().items():
        *path, leaf = name.split(".")
        owner = owners[".".join(path)]
        arr = _f32(tensor)
        if isinstance(owner, (nn.Linear, nn.Conv1d)):
            if leaf == "weight":
                leaf, arr = "w", (arr.T.copy() if arr.ndim == 2 else arr)
            else:
                leaf = "b"
        elif isinstance(owner, LayerNorm) and leaf == "weight":
            leaf = "scale"
        li = -1
        if "blocks" in path:
            cut = path.index("blocks") + 1
            li = int(path[cut])
            path = path[:cut] + path[cut + 1:]
        flat.setdefault(tuple(path) + (leaf,), {})[li] = arr
    tree: dict = {}
    for parts, layers in flat.items():
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = layers[-1] if -1 in layers else np.stack(
            [layers[li] for li in range(len(layers))])
    return tree


def save_params(path: str, params, meta: dict | None = None) -> None:
    """Flat `.npz` save of a parameter tree (nested dicts of numpy or
    torch arrays) or of a port module (through jax_params_from_module),
    in the JAX package's format: keys joined by `/`, bf16 stored as f32,
    and `meta` (JSON-serializable, e.g. the dims' fields) under the
    reserved `__meta__` key, so a loader can rebuild the architecture
    from the checkpoint alone."""
    if isinstance(params, nn.Module):
        params = jax_params_from_module(params)
    flat = {}

    def visit(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, torch.Tensor):
            # npz has no bfloat16: store as f32 (load_params re-casts)
            if node.dtype == torch.bfloat16:
                node = node.float()
            flat[prefix] = node.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(node)

    visit("", params)
    if meta is not None:
        flat["__meta__"] = np.asarray(json.dumps(meta))
    np.savez(path, **flat)


def load_params(path: str, dtype: torch.dtype | None = None) -> dict:
    """Load a flat `.npz` checkpoint (keys like `encoder/blocks/attn/q/w`,
    bf16 stored as f32) into a nested tree, skipping `__meta__`: numpy
    arrays, or with `dtype` torch tensors whose floating leaves are cast
    to it (integer leaves keep their type), as the JAX loader rounds."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__meta__":
                continue
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = data[key]
            if dtype is not None:
                arr = torch.from_numpy(arr)
                if arr.is_floating_point():
                    arr = arr.to(dtype)
            node[parts[-1]] = arr
    return tree


def load_meta(path: str) -> dict | None:
    """The `__meta__` dict saved alongside a `.npz` checkpoint, or None."""
    with np.load(path) as data:
        if "__meta__" not in data.files:
            return None
        return json.loads(str(data["__meta__"]))


def save_checkpoint(path: str, params) -> None:
    """Save a parameter tree (nested dicts of tensors or numpy arrays) or
    a port module's state dict with `torch.save`, numpy leaves as
    tensors."""
    if isinstance(params, nn.Module):
        params = params.state_dict()

    def to_tensor(node):
        if isinstance(node, Mapping):
            return {k: to_tensor(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return node.detach()
        return torch.from_numpy(np.asarray(node))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(to_tensor(params), path)


def load_checkpoint(path: str, like=None):
    """Load a `save_checkpoint` file (`weights_only=True`: tensors and
    plain containers only). `like`, a tree of the same structure (a
    module's state dict, say), gives each leaf its dtype and device;
    without it the leaves come back as saved, on the CPU."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if like is None:
        return tree

    def match(node, ref):
        if isinstance(node, Mapping):
            return {k: match(v, ref[k]) for k, v in node.items()}
        return node.to(dtype=ref.dtype, device=ref.device)

    return match(tree, like)


# ---------------------------------------------------------------------------
# HF Whisper snapshots


def hf_config_from_dims(dims: WhisperDims):
    """A transformers WhisperConfig matching `dims` (offline; transformers
    is imported here only, so nothing else of the port needs it)."""
    from transformers import WhisperConfig

    return WhisperConfig(
        vocab_size=dims.n_vocab,
        num_mel_bins=dims.n_mels,
        d_model=dims.n_audio_state,
        encoder_layers=dims.n_audio_layer,
        encoder_attention_heads=dims.n_audio_head,
        decoder_layers=dims.n_text_layer,
        decoder_attention_heads=dims.n_text_head,
        encoder_ffn_dim=4 * dims.n_audio_state,
        decoder_ffn_dim=4 * dims.n_text_state,
        max_source_positions=dims.n_audio_ctx,
        max_target_positions=dims.n_text_ctx,
        # keep special ids inside small test vocabs
        pad_token_id=0,
        bos_token_id=0,
        eos_token_id=min(dims.n_vocab - 1, 50257),
        decoder_start_token_id=min(dims.n_vocab - 1, 50258),
    )


# transformers.WhisperConfig's defaults, for keys a config.json leaves out
_HF_DEFAULTS = {"num_mel_bins": 80, "max_source_positions": 1500, "d_model": 384,
                "encoder_attention_heads": 6, "encoder_layers": 4, "vocab_size": 51865,
                "max_target_positions": 448, "decoder_attention_heads": 6,
                "decoder_layers": 4}


def dims_from_hf_config(cfg: Mapping[str, Any]) -> WhisperDims:
    """A WhisperConfig's `config.json` mapping → WhisperDims (read as a
    plain mapping: transformers is not needed)."""
    c = {**_HF_DEFAULTS, **cfg}
    return WhisperDims(
        n_mels=c["num_mel_bins"],
        n_audio_ctx=c["max_source_positions"],
        n_audio_state=c["d_model"],
        n_audio_head=c["encoder_attention_heads"],
        n_audio_layer=c["encoder_layers"],
        n_vocab=c["vocab_size"],
        n_text_ctx=c["max_target_positions"],
        n_text_state=c["d_model"],
        n_text_head=c["decoder_attention_heads"],
        n_text_layer=c["decoder_layers"],
    )


def _np(x) -> np.ndarray:
    """A tensor (bf16 too) → f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _linear(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> dict:
    p = {"w": _np(sd[f"{prefix}.weight"]).T}          # (out, in) → (in, out)
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _attn(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"q": _linear(sd, f"{prefix}.q_proj"),
            "k": _linear(sd, f"{prefix}.k_proj", bias=False),
            "v": _linear(sd, f"{prefix}.v_proj"),
            "out": _linear(sd, f"{prefix}.out_proj")}


def _stack(blocks: list[dict]) -> dict:
    """Per-layer trees → one tree of (L, ...) leaves."""
    return {k: _stack([b[k] for b in blocks]) if isinstance(blocks[0][k], dict)
            else np.stack([b[k] for b in blocks]) for k in blocks[0]}


def params_from_hf_state_dict(sd: Mapping[str, Any], dims: WhisperDims,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cpu") -> Whisper:
    """A Whisper module from a transformers WhisperForConditionalGeneration
    state dict ("model.encoder..." or "encoder..." keys): the JAX tree's
    f32 leaves, then cast to `dtype` as the JAX loader casts them."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def mlp(pre):
        return {"fc1": _linear(sd, f"{pre}.fc1"), "fc2": _linear(sd, f"{pre}.fc2")}

    enc_blocks = [{"attn_ln": _ln(sd, f"encoder.layers.{i}.self_attn_layer_norm"),
                   "attn": _attn(sd, f"encoder.layers.{i}.self_attn"),
                   "mlp_ln": _ln(sd, f"encoder.layers.{i}.final_layer_norm"),
                   "mlp": mlp(f"encoder.layers.{i}")}
                  for i in range(dims.n_audio_layer)]
    dec_blocks = [{"attn_ln": _ln(sd, f"decoder.layers.{i}.self_attn_layer_norm"),
                   "attn": _attn(sd, f"decoder.layers.{i}.self_attn"),
                   "cross_ln": _ln(sd, f"decoder.layers.{i}.encoder_attn_layer_norm"),
                   "cross": _attn(sd, f"decoder.layers.{i}.encoder_attn"),
                   "mlp_ln": _ln(sd, f"decoder.layers.{i}.final_layer_norm"),
                   "mlp": mlp(f"decoder.layers.{i}")}
                  for i in range(dims.n_text_layer)]
    params = {
        "encoder": {
            "conv1": {"w": _np(sd["encoder.conv1.weight"]), "b": _np(sd["encoder.conv1.bias"])},
            "conv2": {"w": _np(sd["encoder.conv2.weight"]), "b": _np(sd["encoder.conv2.bias"])},
            "pos_emb": _np(sd["encoder.embed_positions.weight"]),
            "blocks": _stack(enc_blocks),
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_emb": _np(sd["decoder.embed_tokens.weight"]),
            "pos_emb": _np(sd["decoder.embed_positions.weight"]),
            "blocks": _stack(dec_blocks),
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }
    return from_jax_params(params, dims, dtype=dtype, device=device)


def load_hf_snapshot(path: str, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cpu") -> tuple[Whisper, WhisperDims]:
    """A local HF Whisper snapshot directory (`config.json` and
    `model.safetensors` or `pytorch_model.bin`) → (model, dims)."""
    with open(os.path.join(path, "config.json")) as f:
        dims = dims_from_hf_config(json.load(f))
    st_path = os.path.join(path, "model.safetensors")
    pt_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        sd = load_file(st_path)
    elif os.path.exists(pt_path):
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no weights found under {path}")
    return params_from_hf_state_dict(sd, dims, dtype=dtype, device=device), dims


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
