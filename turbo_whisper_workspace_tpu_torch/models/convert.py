"""Weights from the JAX package's parameter tree and `.npz` checkpoints.

Port of turbo_whisper_workspace_tpu/models/convert.py (load_params), plus
`from_jax_params`, which maps the JAX tree onto models/whisper.Whisper:

* `blocks` leaves are stacked along a leading layer axis (L, ...) and
  are split into one module per layer;
* linear weights `w` are stored (d_in, d_out) and become
  `nn.Linear.weight` (d_out, d_in);
* conv weights are OIH, which is torch's conv1d layout, and copy as is;
* LayerNorm `scale`/`bias` become `weight`/`bias`.

One checkpoint thus feeds both packages. The HF snapshot loader waits
for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

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
