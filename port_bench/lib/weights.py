"""Random weights drawn on the card from the run's seed.

A frozen copy of the init distributions the port's random-init models
use (linear weights N(0, 1/d_in), zero biases, unit LayerNorm and
RMSNorm scales, convolutions and embeddings N(0, 0.02²), the encoder's
sinusoidal positions). Each group of weights is one standard-normal draw
in bf16 on the device, cut into views and scaled in place, so the draw
is a few large calls. The same seed gives the same tensors bit for bit,
so the reference draws its own copy after the port's window instead of
keeping the port's alive.

The tensors are named as the port's modules name them: a Whisper
state dict (`nn.Linear` weights (out, in)), and the Llama parameter
dict of `models/llama.py` (projections (in, out)).
"""

from __future__ import annotations

import math

import torch

DTYPE = torch.bfloat16


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for draw stream `stream` of run `seed`."""
    mixed = (int(seed) * 1_000_003 + 7_919 * (stream + 1)) % (1 << 63)
    return torch.Generator(device).manual_seed(mixed)


def draw(leaves: list[tuple[str, tuple, float]], gen: torch.Generator,
         device) -> dict[str, torch.Tensor]:
    """{name: N(0, std²) tensor of `shape`} for each (name, shape, std),
    all views of one bf16 draw."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=gen, device=device, dtype=DTYPE)
    out, at = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """openai/whisper's fixed encoder positions, (length, channels) f32."""
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-log_inc * torch.arange(channels // 2, dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float()


# ---------------------------------------------------------------------------
# Whisper


def whisper_state(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The Whisper state dict of configuration `cfg` (HF key names)."""
    d, mels, vocab = cfg["d_model"], cfg["num_mel_bins"], cfg["vocab_size"]
    ff = cfg["encoder_ffn_dim"]
    leaves = [("encoder.conv1.weight", (d, mels, 3), 0.02),
              ("encoder.conv2.weight", (d, d, 3), 0.02)]
    ones, zeros = [], ["encoder.conv1.bias", "encoder.conv2.bias"]

    def block(prefix: str, cross: bool, ff: int):
        attns = ("attn", "cross") if cross else ("attn",)
        for a in attns:
            for p in ("q", "k", "v", "out"):
                leaves.append((f"{prefix}.{a}.{p}.weight", (d, d), d ** -0.5))
                if p != "k":
                    zeros.append(f"{prefix}.{a}.{p}.bias")
        leaves.append((f"{prefix}.mlp.fc1.weight", (ff, d), d ** -0.5))
        leaves.append((f"{prefix}.mlp.fc2.weight", (d, ff), ff ** -0.5))
        zeros.extend([f"{prefix}.mlp.fc1.bias", f"{prefix}.mlp.fc2.bias"])
        for ln in ("attn_ln", "cross_ln", "mlp_ln") if cross else ("attn_ln", "mlp_ln"):
            ones.append(f"{prefix}.{ln}.weight")
            zeros.append(f"{prefix}.{ln}.bias")

    for i in range(cfg["encoder_layers"]):
        block(f"encoder.blocks.{i}", False, ff)
    leaves.append(("decoder.token_emb", (vocab, d), 0.02))
    leaves.append(("decoder.pos_emb", (cfg["max_target_positions"], d), 0.02))
    for i in range(cfg["decoder_layers"]):
        block(f"decoder.blocks.{i}", True, cfg["decoder_ffn_dim"])
    ones += ["encoder.ln_post.weight", "decoder.ln.weight"]
    zeros += ["encoder.ln_post.bias", "decoder.ln.bias"]

    state = draw(leaves, generator(seed, 0, device), device)
    for name in ones:
        state[name] = torch.ones(d, dtype=DTYPE, device=device)
    for name in zeros:
        n = ff if name.endswith("fc1.bias") else d
        state[name] = torch.zeros(n, dtype=DTYPE, device=device)
    state["encoder.pos_emb"] = sinusoids(cfg["max_source_positions"], d).to(device, DTYPE)
    return state


# ---------------------------------------------------------------------------
# Llama architecture (models/llama.py's parameter dict)

PROJECTIONS = ("q", "k", "v", "out", "gate", "up", "down")


def llama_shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    kv = cfg["num_key_value_heads"] * (d // cfg["num_attention_heads"])
    return {"q": (d, d), "k": (d, kv), "v": (d, kv), "out": (d, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d)}


def llama_layer(cfg: dict, seed: int, layer: int, device) -> dict[str, torch.Tensor]:
    """Layer `layer`'s seven projections {name: (d_in, d_out) bf16}."""
    shapes = llama_shapes(cfg)
    leaves = [(p, shapes[p], shapes[p][0] ** -0.5) for p in PROJECTIONS]
    return draw(leaves, generator(seed, layer + 1, device), device)


def llama_ends(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The token embedding (vocab, d) and the output head (d, vocab)."""
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    return draw([("token_emb", (vocab, d), 0.02), ("lm_head", (d, vocab), d ** -0.5)],
                generator(seed, 0, device), device)
