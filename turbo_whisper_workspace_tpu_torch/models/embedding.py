"""Speaker-embedding extractor (x-vector-style) + deterministic DSP fallback.

Port of turbo_whisper_workspace_tpu/models/embedding.py. log-mel → a
strided stem conv → residual conv blocks (a channel LayerNorm over a
transpose) → attentive statistics pooling in float32 → projection →
LayerNorm → L2-normalised 192-d vector. Float32 weights run with TF32
off on the card (`ops/mel.full_f32`).

`spectral_spec_device` and `spectral_embedding_from_spec` are the two
halves of the weight-free fallback: the device half reduces each crop
to an 80-float energy-weighted log-mel spectrum, the host half
standardises across the batch and L2-normalises. `spectral_embedding`
is the same function on a host mel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import mel as mel_ops
from .whisper import LayerNorm


@dataclass(frozen=True)
class EmbeddingDims:
    n_mels: int = 80
    channels: int = 256
    n_blocks: int = 4
    embed_dim: int = 192
    crop_frames: int = 200     # 2 s crops (hop 160)


class EmbeddingBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv1d(c, c, 3, padding=1)
        self.conv2 = nn.Conv1d(c, c, 3, padding=1)
        self.ln = LayerNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.conv2(F.gelu(self.conv1(x)))
        # channel LN over (B, C, T): normalise the channel axis
        return self.ln(h.transpose(1, 2)).transpose(1, 2)


class Embedding(nn.Module):
    """Parameter names follow the JAX tree (stem, blocks, att, proj,
    ln_out); models/convert.py maps one onto the other."""

    def __init__(self, dims: EmbeddingDims):
        super().__init__()
        c = dims.channels
        self.dims = dims
        self.stem = nn.Conv1d(dims.n_mels, c, 5, stride=2, padding=2)
        self.blocks = nn.ModuleList(EmbeddingBlock(c) for _ in range(dims.n_blocks))
        self.att = nn.Linear(c, 1)
        self.proj = nn.Linear(2 * c, dims.embed_dim)
        self.ln_out = LayerNorm(dims.embed_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """JAX `forward`: mel (B, n_mels, T) → L2-normalised embeddings
        (B, embed_dim), f32."""
        with mel_ops.full_f32():
            dtype = self.stem.weight.dtype
            x = F.gelu(self.stem(mel.to(dtype)))
            for block in self.blocks:
                x = block(x)
            # attentive statistics pooling, in f32
            feats = x.transpose(1, 2)                              # (B, T, C)
            att = torch.softmax(self.att(feats).float(), dim=1)    # (B, T, 1)
            feats32 = feats.float()
            mean = (att * feats32).sum(1)
            var = (att * (feats32 - mean[:, None]) ** 2).sum(1)
            pooled = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)
            emb = self.ln_out(self.proj(pooled.to(dtype))).float()
            return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def init_params(dims: EmbeddingDims, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> Embedding:
    """Random-init module with the JAX init's distributions: stem
    N(0, 0.05²), block convs N(0, 0.02²), linear weights N(0, 1/d_in),
    zero biases, unit/zero LayerNorms. Draws come from `generator` (f32,
    on its device), so they differ from JAX's."""
    device = torch.device(device) if device is not None else generator.device
    with torch.device(generator.device):
        model = Embedding(dims)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device,
                           dtype=torch.float32) * std

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(normal(mod.weight.shape, mod.in_features ** -0.5))
            elif isinstance(mod, nn.Conv1d):
                mod.weight.copy_(normal(mod.weight.shape, 0.05 if mod is model.stem else 0.02))
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                mod.bias.zero_()
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def spectral_spec_device(audio: torch.Tensor, crop_frames: int = 200) -> torch.Tensor:
    """Device half of the weight-free fallback: (B, crop_samples) PCM
    (int16 or float) on any device → (B, n_mels) energy-weighted
    time-averaged log-mel spectrum with per-crop loudness removed, on the
    same device. Only ~80 floats a crop cross back to the host instead
    of the (B, 80, 200) mel."""
    mel = mel_ops.log_mel_spectrogram(audio, num_mels=80)[:, :, :crop_frames]
    w = torch.exp(mel - mel.amax(dim=(1, 2), keepdim=True)).mean(1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    spec = (mel * w[:, None, :]).sum(-1)
    return spec - spec.mean(-1, keepdim=True)


def spectral_embedding_from_spec(spec: np.ndarray) -> np.ndarray:
    """Host half: standardize per feature ACROSS the batch, L2-normalize
    (same semantics as spectral_embedding's tail)."""
    emb = (spec - spec.mean(0, keepdims=True)) / (
        spec.std(0, keepdims=True) + 1e-9
    )
    return emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-9)


def spectral_embedding(mel: np.ndarray) -> np.ndarray:
    """Weight-free fallback on a host mel: (B, n_mels, T) log-mel → (B,
    n_mels) energy-weighted time-averaged spectrum with per-crop loudness
    removed, standardized per feature ACROSS the batch (one file's crops
    arrive together, so this adapts to the recording), then
    L2-normalized. Deterministic; separates spectrally distinct voices."""
    mel = np.asarray(mel, np.float32)
    # frame weights: softmax-like energy share per crop
    w = np.exp(mel - mel.max(axis=(1, 2), keepdims=True)).mean(1)  # (B, T)
    w = w / (w.sum(-1, keepdims=True) + 1e-9)
    spec = (mel * w[:, None, :]).sum(-1)                           # (B, M)
    spec = spec - spec.mean(-1, keepdims=True)    # remove crop loudness
    return spectral_embedding_from_spec(spec)
