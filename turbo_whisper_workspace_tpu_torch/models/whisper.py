"""Whisper encoder-decoder as torch nn.Modules.

Port of turbo_whisper_workspace_tpu/models/whisper.py: the encoder and
the decoder with its three self-KV caches (bf16; int8 with per-(head,
position) scales; int8 beam "lane" panels) and int8 or dense cross-KV.
Blocks are one module per layer instead of the JAX package's
layer-stacked leaves under `lax.scan`; models/convert.py maps one
layout onto the other. The decoder takes and returns the JAX package's
cache and cross-KV dicts with their (L, B, ...) layouts, so the
transcriber's row gather, beam search and the parity tests see the
same arrays.

Kernel routing follows the inputs and one argument: the encoder's long
self-attention calls `ops.attention.flash_attention`, int8
cross-attention `ops.attention.cross_attention_int8` (or, when the
caller passes `cross_s8=True`, `cross_attention_s8`: the JAX package's
trace-time `TWW_CROSS_S8=1`, chosen here by
`TranscriptionConfig.cross_attention_s8`), a decode step over the int8
cache `self_attention_int8` and a beam step over the lane cache
`self_attention_int8_lanes`; the self-attention over the bf16 cache
`ops.llama_ops.llama_attention` (group 1). The work XLA fuses around
them in the JAX package takes `ops.whisper_ops`' kernels: every
LayerNorm of the encoder and the decoder with the residual add before it
(`whisper_norm`, the decoder's embeddings in its entry mode) and the
cache writes with the int8 row quantizer (`whisper_kv_rows`). Each
launches its CUDA kernel for CUDA tensors and runs its plain version for
CPU tensors. In a forward that autograd records (a training step) the
norms still launch their kernel, behind an autograd Function whose
backward recomputes the plain version's torch ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as att
from ..ops import llama_ops as lo
from ..ops import whisper_ops as wo


@dataclass(frozen=True)
class WhisperDims:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _dims(mels, astate, ahead, alayer, vocab, tstate, thead, tlayer):
    return WhisperDims(
        n_mels=mels,
        n_audio_ctx=1500,
        n_audio_state=astate,
        n_audio_head=ahead,
        n_audio_layer=alayer,
        n_vocab=vocab,
        n_text_ctx=448,
        n_text_state=tstate,
        n_text_head=thead,
        n_text_layer=tlayer,
    )


# openai/whisper ModelDimensions per checkpoint family.
WHISPER_CONFIGS: dict[str, WhisperDims] = {
    "tiny.en": _dims(80, 384, 6, 4, 51864, 384, 6, 4),
    "tiny": _dims(80, 384, 6, 4, 51865, 384, 6, 4),
    "base.en": _dims(80, 512, 8, 6, 51864, 512, 8, 6),
    "base": _dims(80, 512, 8, 6, 51865, 512, 8, 6),
    "small.en": _dims(80, 768, 12, 12, 51864, 768, 12, 12),
    "small": _dims(80, 768, 12, 12, 51865, 768, 12, 12),
    "medium.en": _dims(80, 1024, 16, 24, 51864, 1024, 16, 24),
    "medium": _dims(80, 1024, 16, 24, 51865, 1024, 16, 24),
    "large-v2": _dims(80, 1280, 20, 32, 51865, 1280, 20, 32),
    "large-v3": _dims(128, 1280, 20, 32, 51866, 1280, 20, 32),
    "large-v3-turbo": _dims(128, 1280, 20, 32, 51866, 1280, 20, 4),
}


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Fixed sinusoidal positions for the audio encoder."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Layers


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics whatever the activation dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return wo.layer_norm(x, self.weight, self.bias, self.eps)


def fused_norm(x: torch.Tensor, ln: LayerNorm, delta: torch.Tensor | None = None):
    """(x + delta, ln(x + delta)) by `whisper_norm` (x' is x without delta)."""
    return wo.whisper_norm(x, ln.weight, ln.bias, ln.eps, delta)


def plain_norm(x: torch.Tensor, ln: LayerNorm, delta: torch.Tensor | None = None):
    """fused_norm's arithmetic in torch ops on every device."""
    return wo.whisper_norm_reference(x, ln.weight, ln.bias, ln.eps, delta)


def _plain_attention(q, k, v, n_head: int, mask=None) -> torch.Tensor:
    """(B, Tq, D) x (B, Tk, D) → (B, Tq, D): f32 logits and softmax,
    weights in the activation dtype, as the JAX `mha` einsum path."""
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // n_head
    qh = q.reshape(b, tq, n_head, dh)
    kh = k.reshape(b, tk, n_head, dh)
    vh = v.reshape(b, tk, n_head, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * dh ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, vh).reshape(b, tq, d)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention, (B, Tq, D) x (B, Tk, D) → (B, Tq, D).

    Unmasked self-attention over ≥ 256 positions (the encoder's 1500
    frames) goes to the flash_attention kernel, as in the JAX `mha`."""
    b, tq, d = q.shape
    if mask is None and tq == k.shape[1] and tq >= 256:
        # (B, H, T, Dh) views of the (B, T, D) projections, no copies: the
        # kernel reads a head as a column slice of each row, and writes
        # the output in the same layout
        def heads(x):
            return x.reshape(b, tq, n_head, d // n_head).transpose(1, 2)

        out = att.flash_attention(heads(q), heads(k), heads(v))
        return out.transpose(1, 2).reshape(b, tq, d)
    return _plain_attention(q, k, v, n_head, mask)


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)


class MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: self-attention [+ cross-attention] + MLP. Parameter
    names follow the JAX block tree (attn_ln, attn, cross_ln, cross,
    mlp_ln, mlp)."""

    def __init__(self, d: int, n_head: int, cross: bool):
        super().__init__()
        self.n_head = n_head
        self.attn_ln = LayerNorm(d)
        self.attn = MultiHeadAttention(d)
        if cross:
            self.cross_ln = LayerNorm(d)
            self.cross = MultiHeadAttention(d)
        self.mlp_ln = LayerNorm(d)
        self.mlp = MLP(d)

    def forward(self, x: torch.Tensor, delta: torch.Tensor | None = None,
                norm=plain_norm) -> tuple[torch.Tensor, torch.Tensor]:
        """Encoder block, unmasked self-attention + MLP, on the residual
        stream x + delta (x alone without delta) → (x', delta'), whose sum
        is the block's output: each residual add rides the next norm call
        (`norm`, fused_norm's signature), the last one the caller's."""
        x, h = norm(x, self.attn_ln, delta)
        a = self.attn
        x, h = norm(x, self.mlp_ln, a.out(mha(a.q(h), a.k(h), a.v(h), self.n_head)))
        return x, self.mlp(h)


# ---------------------------------------------------------------------------
# Encoder


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.register_buffer("pos_emb", torch.from_numpy(sinusoids(dims.n_audio_ctx, d)))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_audio_head, cross=False)
            for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """JAX `encoder_forward`: mel (B, n_mels, 3000) → audio features
        (B, 1500, d)."""
        x = mel.to(self.conv1.weight.dtype)
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        x = (x.transpose(1, 2) + self.pos_emb.to(x.dtype)).contiguous()
        delta = None
        for block in self.blocks:
            x, delta = block(x, delta, norm=fused_norm)
        return fused_norm(x, self.ln_post, delta)[1]


# ---------------------------------------------------------------------------
# Decoder


class TextDecoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_text_state
        self.dims = dims
        # heads this module's attention projections hold: all of them, or
        # a tensor-parallel rank's share (parallel/sharding.shard_params)
        self.n_head = dims.n_text_head
        self.token_emb = nn.Parameter(torch.zeros(dims.n_vocab, d))
        self.pos_emb = nn.Parameter(torch.zeros(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_text_head, cross=True)
            for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d)

    def precompute_cross_kv(self, audio_features: torch.Tensor,
                            quantize: bool = False) -> dict:
        """JAX `precompute_cross_kv`: K/V of every layer's cross-attention
        over the encoder output, head-major {"k", "v"} (L, B, H, 1500, Dh);
        quantize=True returns quantize_cross_kv_int8's int8 dict instead."""
        b, t, _ = audio_features.shape
        h = self.n_head

        def heads(x):
            return x.reshape(b, t, h, x.shape[-1] // h).transpose(1, 2)

        k = torch.stack([heads(blk.cross.k(audio_features)) for blk in self.blocks])
        v = torch.stack([heads(blk.cross.v(audio_features)) for blk in self.blocks])
        if quantize:
            return att.quantize_cross_kv_int8(k, v)
        return {"k": k, "v": v}

    def _cross_attention(self, q: torch.Tensor, cross_kv: dict, li: int,
                         beam: int = 1, cross_s8: bool = False) -> torch.Tensor:
        """q (B, Tq, D) over layer li's cross-KV → (B, Tq, D). With beam > 1
        the rows are B·K beams of one step: (B·K, 1, D) → (B, H, K, Dh), so
        the K beams of a batch item ride the query axis and share one read
        of its cross-KV, which stays at batch B. An int8 cross-KV goes to
        cross_attention_s8 with cross_s8, else to cross_attention_int8."""
        b, tq, d = q.shape
        h = self.n_head
        if beam > 1:
            qh = q.reshape(b // beam, beam, h, d // h)
        else:
            qh = q.reshape(b, tq, h, d // h)
        qh = qh.transpose(1, 2).contiguous()
        if "k_q" in cross_kv:
            kernel = att.cross_attention_s8 if cross_s8 else att.cross_attention_int8
            out = kernel(
                qh, cross_kv["k_q"][li], cross_kv["v_q"][li],
                cross_kv["k_scale"][li], cross_kv["v_scale"][li],
                seq_len=self.dims.n_audio_ctx)
        else:
            ck, cv = cross_kv["k"][li], cross_kv["v"][li]
            logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), ck.float())
            weights = torch.softmax(logits * (d // h) ** -0.5, dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", weights, cv.to(q.dtype))
        return out.transpose(1, 2).reshape(b, tq, d)

    def _self_attention(self, li: int, q, k, v, cache: dict, pos: int | torch.Tensor,
                        valid_len: int | torch.Tensor, mask, beam: int,
                        lane_map) -> torch.Tensor:
        """Layer li's self-attention, (B, T, D) → (B, T, D), after writing
        this call's K/V rows into the cache IN PLACE at [pos, pos+T)
        (`whisper_kv_rows`; the JAX package returns an updated copy). Keys
        t ≥ valid_len = pos+T are masked: the bf16 cache's attention
        (`llama_attention`) reads pos, a host int or the 0-dim tensor of
        the step a CUDA graph replays, and the int8 kernels read
        valid_len, a device int32 at a tensor pos."""
        b, t, d = q.shape
        h = self.n_head
        dh = d // h
        wo.whisper_kv_rows(k, v, cache, li, pos, h, beam)
        if "k_p" in cache:
            # (L, B, ...) panels → one layer's contiguous (B, ...) views, no copies
            br = b // beam
            kt = beam * cache["k_p"].shape[-1]
            out = att.self_attention_int8_lanes(
                q.reshape(br, beam, h, dh).transpose(1, 2).contiguous(),
                cache["k_p"][li].reshape(br, d, kt), cache["k_ps"][li].reshape(br, h, kt),
                cache["v_p"][li].reshape(br, kt, d), cache["v_ps"][li].reshape(br, h, kt),
                lane_map, valid_len)
            return out.transpose(1, 2).reshape(b, t, d)
        if "k_q" in cache:
            qh = q.reshape(b, t, h, dh).transpose(1, 2)
            if t == 1:
                out = att.self_attention_int8(
                    qh.contiguous(), cache["k_q"][li], cache["k_s"][li],
                    cache["v_q"][li], cache["v_s"][li], valid_len)
            else:
                out = att.self_attention_int8_xla(
                    qh, cache["k_q"][li, :, :, :valid_len], cache["k_s"][li, :, :, :valid_len],
                    cache["v_q"][li, :, :, :valid_len], cache["v_s"][li, :, :, :valid_len],
                    mask)
            return out.transpose(1, 2).reshape(b, t, d)
        return lo.llama_attention(q.reshape(b, t, h, dh), cache["k"][li], cache["v"][li], pos)

    def forward(self, tokens: torch.Tensor, cross_kv: dict,
                kv_cache: dict | None = None, pos: int | torch.Tensor = 0, beam: int = 1,
                lane_map: torch.Tensor | None = None, cross_s8: bool = False):
        """JAX `decoder_forward`: tokens (B, T) at positions [pos, pos+T) →
        (logits (B, T, V) f32, kv_cache). Prefill when T > 1, one step when T == 1.

        kv_cache is one of init_kv_cache's dicts (bf16 {"k", "v"}, or int8
        {"k_q", "v_q", "k_s", "v_s"}) or beam_lane_cache's lane panels,
        and is WRITTEN IN PLACE at [pos, pos+T) — the JAX package returns
        an updated copy (dynamic_update_slice); here the caller's tensors
        change. Without a cache the call is teacher-forced from position 0.

        beam > 1: one step (T == 1) of B·K beam rows (row b·K + k) over a
        cross-KV at batch B. The lane cache needs beam == its lane count
        and lane_map (B, K, cache length) int32, the lane each beam reads
        at each position.

        cross_s8: an int8 cross-KV is read by cross_attention_s8 instead
        of cross_attention_int8 (the JAX package's TWW_CROSS_S8=1).

        pos may be a 0-dim int64 tensor on the tokens' device for one step
        (T == 1, any beam) over any of the three caches: the step a CUDA
        graph replays. Its position embedding (`whisper_embed_norm`),
        cache rows (`whisper_kv_rows`) and key count all read from it:
        `llama_attention` reads it for the bf16 cache, the int8 kernels
        get pos + 1 as a device int32.

        Each residual add rides the next norm's `whisper_norm` call (the
        last one `ln`'s), as the encoder's do."""
        b, t = tokens.shape
        use_cache = kv_cache is not None
        if not use_cache:
            pos = 0
        mask = None
        if torch.is_tensor(pos):
            if t != 1:
                raise ValueError(f"a tensor pos takes one step (T == 1), got T={t}")
            # the int8 kernels' key count; the bf16 cache's attention reads pos
            valid_len = None if "k" in kv_cache else (pos + 1).to(torch.int32).view(1)
        else:
            valid_len = pos + t
            if t > 1 and not (use_cache and "k" in kv_cache):    # the bf16 cache's reads pos
                key_pos = torch.arange(pos + t, device=tokens.device)
                q_pos = pos + torch.arange(t, device=tokens.device)
                mask = (key_pos[None, :] <= q_pos[:, None])[None, None]
        if beam > 1 and t != 1:
            raise ValueError(f"beam={beam} decodes one step at a time, got T={t}")
        if use_cache and "k_p" in kv_cache and (lane_map is None or beam != kv_cache["k_p"].shape[3]):
            raise ValueError("the lane cache needs lane_map and beam equal to its "
                             f"{kv_cache['k_p'].shape[3]} lanes, got beam={beam}")

        ln0 = self.blocks[0].attn_ln
        x, h = wo.whisper_embed_norm(tokens.contiguous(), self.token_emb, self.pos_emb, pos,
                                     ln0.weight, ln0.bias, ln0.eps)
        delta = None
        for li, block in enumerate(self.blocks):
            if li:
                x, h = fused_norm(x, block.attn_ln, delta)
            a = block.attn
            if use_cache:
                attn = self._self_attention(li, a.q(h), a.k(h), a.v(h), kv_cache, pos,
                                            valid_len, mask, beam, lane_map)
            else:
                # teacher-forced: the keys are this call's, no cache is written
                # (so autograd sees no in-place update)
                attn = mha(a.q(h), a.k(h), a.v(h), self.n_head, mask=mask)
            x, h = fused_norm(x, block.cross_ln, a.out(attn))
            c = block.cross
            x, h = fused_norm(x, block.mlp_ln,
                              c.out(self._cross_attention(c.q(h), cross_kv, li, beam, cross_s8)))
            delta = block.mlp(h)

        x = fused_norm(x, self.ln, delta)[1].reshape(b * t, -1)
        if x.is_cuda and x.dtype != torch.float32 and not x.requires_grad:
            # f32 logits from bf16 operands with f32 sums, as the JAX
            # einsum's preferred_element_type=f32; torch.mm's out_dtype
            # has no CPU kernel and no derivative, so the CPU (f32 in the
            # tests) and a training step upcast
            logits = torch.mm(x, self.token_emb.t(), out_dtype=torch.float32)
        else:
            logits = x.float() @ self.token_emb.float().t()
        return logits.reshape(b, t, -1), (kv_cache if use_cache else None)


class Whisper(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.token_emb.dtype

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """JAX `forward`: teacher-forced (mel, tokens) → logits (B, T, V)."""
        cross_kv = self.decoder.precompute_cross_kv(self.encoder(mel))
        return self.decoder(tokens, cross_kv)[0]


def param_count(model: nn.Module) -> int:
    """Elements of every weight in the model's state dict: its parameters
    and the encoder's sinusoidal `pos_emb` buffer, which is a leaf of the
    JAX package's parameter tree, so the count equals JAX `param_count`
    of the same dims."""
    return sum(t.numel() for t in model.state_dict().values())


# ---------------------------------------------------------------------------
# Initialization and cache


def init_params(dims: WhisperDims, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> Whisper:
    """Random-init model with the JAX init's distributions: linear
    weights N(0, 1/d_in) and zero biases, unit/zero LayerNorms, convs
    and embeddings N(0, 0.02²), sinusoidal encoder positions. Draws come
    from `generator` (f32, on its device), so they differ from JAX's."""
    device = torch.device(device) if device is not None else generator.device
    with torch.device(generator.device):
        model = Whisper(dims)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device,
                           dtype=torch.float32) * std

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(normal(mod.weight.shape, mod.in_features ** -0.5))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                mod.weight.copy_(normal(mod.weight.shape, 0.02))
                mod.bias.zero_()
        model.decoder.token_emb.copy_(normal(model.decoder.token_emb.shape, 0.02))
        model.decoder.pos_emb.copy_(normal(model.decoder.pos_emb.shape, 0.02))
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def init_kv_cache(dims: WhisperDims, batch: int, max_len: int | None = None,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu", quantize: bool = False,
                  n_head: int | None = None) -> dict:
    """Preallocated self-attention cache of n_head heads (default all
    dims.n_text_head; a tensor-parallel rank passes its decoder's
    `n_head`), each of the model's head width Dh, D = n_head·Dh.

    quantize=False: {"k","v"} (L, B, max_len, D) in `dtype`.
    quantize=True: head-major int8 payload {"k_q","v_q"} (L, B, H,
    max_len, Dh) with per-(head, position) scales {"k_s","v_s"} (L, B, H,
    max_len) in bf16 whatever `dtype` is, as in the JAX package."""
    max_len = max_len or dims.n_text_ctx
    h = n_head or dims.n_text_head
    dh = dims.n_text_state // dims.n_text_head
    if not quantize:
        shape = (dims.n_text_layer, batch, max_len, h * dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    qshape = (dims.n_text_layer, batch, h, max_len, dh)
    sshape = qshape[:-1]
    return {"k_q": torch.zeros(qshape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(qshape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            "v_s": torch.zeros(sshape, dtype=torch.bfloat16, device=device)}


def beam_lane_cache(cache_b: dict, beam: int) -> dict:
    """Quantized (L, B, H, T, Dh) prefill cache → the beam "lane" panels
    that self_attention_int8_lanes reads, in the JAX package's layouts:

      k_p  (L, B, H·Dh, K, T) int8  (one layer's (B, H·Dh, K·T) K panel)
      v_p  (L, B, K, T, H·Dh) int8  (one layer's (B, K·T, H·Dh) V panel)
      k_ps, v_ps (L, B, H, K, T)    per-(head, position) scales

    The shared prompt goes in lane 0 only (every beam's lane_map starts
    at 0); lanes 1..K-1 start zeroed and fill as beams write their rows."""
    l, b, h, t, dh = cache_b["k_q"].shape
    dev = cache_b["k_q"].device
    sdtype = cache_b["k_s"].dtype
    k_p = torch.zeros((l, b, h * dh, beam, t), dtype=torch.int8, device=dev)
    k_p[:, :, :, 0] = cache_b["k_q"].transpose(3, 4).reshape(l, b, h * dh, t)
    v_p = torch.zeros((l, b, beam, t, h * dh), dtype=torch.int8, device=dev)
    v_p[:, :, 0] = cache_b["v_q"].permute(0, 1, 3, 2, 4).reshape(l, b, t, h * dh)
    k_ps = torch.zeros((l, b, h, beam, t), dtype=sdtype, device=dev)
    k_ps[:, :, :, 0] = cache_b["k_s"]
    v_ps = torch.zeros((l, b, h, beam, t), dtype=sdtype, device=dev)
    v_ps[:, :, :, 0] = cache_b["v_s"]
    return {"k_p": k_p, "v_p": v_p, "k_ps": k_ps, "v_ps": v_ps}

