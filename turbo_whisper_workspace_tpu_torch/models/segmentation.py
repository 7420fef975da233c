"""Speaker segmentation: powerset multi-speaker activity over sliding windows.

Port of turbo_whisper_workspace_tpu/models/segmentation.py. A 10 s
window's log-mel goes through a conv downsampler (1000 → 200 → 100
frames), learned positions and a small pre-LN transformer of
models/whisper.ResidualAttentionBlock, to per-frame logits over the
7-class powerset of up to 3 local speakers (∅, A, B, C, AB, AC, BC).

At the default 100 frames a window, attention takes `mha`'s plain path
(below its 256-frame flash threshold), as the JAX `mha` does. Float32
weights run with TF32 off on the card (`ops/mel.full_f32`), so an f32
forward does not depend on the caller's global TF32 setting.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import mel as mel_ops
from .whisper import LayerNorm, ResidualAttentionBlock, plain_norm, sinusoids

# powerset for ≤3 simultaneous local speakers
POWERSET = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2))
N_CLASSES = len(POWERSET)
MAX_LOCAL_SPEAKERS = 3

WINDOW_S = 10.0
FRAMES_PER_WINDOW = 100   # 10 frames/s after 10x downsample of mel frames


@dataclass(frozen=True)
class SegmentationDims:
    n_mels: int = 80
    d_model: int = 256
    n_head: int = 4
    n_layer: int = 4
    n_classes: int = N_CLASSES
    window_frames: int = 1000     # mel frames per 10 s window (hop 160)
    downsample: int = 10          # → 100 output frames (10 Hz)


class Segmentation(nn.Module):
    """Parameter names follow the JAX tree (conv1, conv2, pos_emb,
    blocks, ln, head); models/convert.py maps one onto the other."""

    def __init__(self, dims: SegmentationDims):
        super().__init__()
        d = dims.d_model
        self.dims = dims
        self.conv1 = nn.Conv1d(dims.n_mels, d, 5, stride=dims.downsample // 2, padding=2)
        self.conv2 = nn.Conv1d(d, d, 5, stride=2, padding=2)
        self.pos_emb = nn.Parameter(torch.zeros(dims.window_frames // dims.downsample, d))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_head, cross=False) for _ in range(dims.n_layer))
        self.ln = LayerNorm(d)
        self.head = nn.Linear(d, dims.n_classes)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """JAX `forward`: mel (B, n_mels, window_frames) → powerset logits
        (B, T_out, n_classes), float32."""
        with mel_ops.full_f32():
            x = mel.to(self.conv1.weight.dtype)
            x = F.gelu(self.conv1(x))
            x = F.gelu(self.conv2(x))
            x = x.transpose(1, 2)
            x = x + self.pos_emb.to(x.dtype)[: x.shape[1]]
            delta = None
            for block in self.blocks:
                x, delta = block(x, delta)
            return self.head(plain_norm(x, self.ln, delta)[1]).float()


def init_params(dims: SegmentationDims, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> Segmentation:
    """Random-init module with the JAX init's distributions: conv1
    N(0, 0.05²), conv2 N(0, 0.02²), linear weights N(0, 1/d_in), zero
    biases, unit/zero LayerNorms, sinusoidal positions. Draws come from
    `generator` (f32, on its device), so they differ from JAX's."""
    device = torch.device(device) if device is not None else generator.device
    with torch.device(generator.device):
        model = Segmentation(dims)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device,
                           dtype=torch.float32) * std

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(normal(mod.weight.shape, mod.in_features ** -0.5))
                if mod.bias is not None:
                    mod.bias.zero_()
        model.conv1.weight.copy_(normal(model.conv1.weight.shape, 0.05))
        model.conv2.weight.copy_(normal(model.conv2.weight.shape, 0.02))
        model.conv1.bias.zero_()
        model.conv2.bias.zero_()
        model.pos_emb.copy_(torch.from_numpy(sinusoids(*model.pos_emb.shape)))
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def powerset_to_activity(logits: np.ndarray) -> np.ndarray:
    """(B, T, n_classes) argmax → (B, T, MAX_LOCAL_SPEAKERS) activity bools."""
    cls = np.argmax(logits, axis=-1)
    act = np.zeros(cls.shape + (MAX_LOCAL_SPEAKERS,), bool)
    for ci, members in enumerate(POWERSET):
        mask = cls == ci
        for m in members:
            act[mask, m] = True
    return act


def powerset_speech_prob(logits: np.ndarray) -> np.ndarray:
    """(B, T, n_classes) → (B, T) P(any speaker active) = 1 - P(∅).

    Soft per-frame speech probability so overlapping sliding windows can
    be averaged (pyannote's overlap aggregation) before thresholding."""
    x = logits - logits.max(-1, keepdims=True)
    p = np.exp(x)
    p /= p.sum(-1, keepdims=True)
    return 1.0 - p[..., 0]
