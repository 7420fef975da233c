"""KV-cached greedy / sampled decode.

Port of turbo_whisper_workspace_tpu/decode/greedy.py. The JAX package
runs the loop as one `lax.while_loop` inside one jit; here it is a
Python loop over decoder steps that stops when every row has emitted
EOT (`finished.all()`, one host sync per step) or after max_len steps.
Returned bookkeeping mirrors openai/whisper's DecodingResult fields the
long-form fallbacks need (avg_logprob, no_speech_prob). `greedy_decode`
and `detect_language` take log-mel input: the encoder, then the dense
cross-KV, then the `*_features` function, as the JAX helpers do.

Sampling at temperature T > 0 is gumbel-max, argmax(logits + T·G), with
G drawn from the caller's `torch.Generator`; its draws differ from the
JAX package's `rbg` key, so sampled tokens do not match it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import whisper as wm
from .rules import DecodeRules, update_ts_floor


class DecodeResult(NamedTuple):
    tokens: torch.Tensor          # (B, P + max_len) int64, EOT-padded
    lengths: torch.Tensor         # (B,) sampled tokens before EOT
    sum_logprobs: torch.Tensor    # (B,) f32 over sampled tokens (incl. EOT)
    avg_logprobs: torch.Tensor    # (B,)
    no_speech_probs: torch.Tensor  # (B,) P(<|nospeech|>) at the SOT position


@torch.no_grad()
def greedy_decode_features(
    model: wm.Whisper,
    cross_kv: dict,
    prompt: torch.Tensor,              # (B, P) int64
    *,
    rules: DecodeRules,
    max_len: int = 224,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    sot_index: int = 0,
    cross_s8: bool = False,
) -> DecodeResult:
    """cross_s8: an int8 cross-KV is read by the s8×s8 cross-attention
    kernel (TranscriptionConfig.cross_attention_s8)."""
    dims = model.dims
    sp = rules.specials
    device = prompt.device
    b, p = prompt.shape
    total = p + max_len
    if total > dims.n_text_ctx:
        raise ValueError(f"prompt {p} + max_len {max_len} exceeds n_text_ctx "
                         f"{dims.n_text_ctx}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device).manual_seed(0)

    cache = wm.init_kv_cache(dims, b, max_len=total, dtype=model.dtype,
                             device=device, n_head=model.decoder.n_head)
    static_mask = rules.static_mask(device)
    begin_mask = rules.begin_mask(device)

    # prefill the prompt in one pass
    prefill_logits, cache = model.decoder(prompt, cross_kv, cache, pos=0,
                                         cross_s8=cross_s8)
    no_speech_probs = torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, sp.no_speech]

    tokens = torch.cat(
        [prompt, torch.full((b, max_len), sp.eot, dtype=prompt.dtype, device=device)], 1)
    # Pairing state looks at SAMPLED tokens only (openai/whisper): before
    # anything is sampled, "last" is a non-timestamp sentinel and
    # "penultimate" counts as a timestamp.
    ts_sentinel = torch.full((b,), sp.timestamp_begin, dtype=torch.long, device=device)
    last_logits = prefill_logits[:, -1]
    last_tok = torch.zeros(b, dtype=torch.long, device=device)
    penult_tok = ts_sentinel
    ts_floor = ts_sentinel
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    sum_logprobs = torch.zeros(b, dtype=torch.float32, device=device)

    for step in range(max_len):
        masked = rules.apply(last_logits, step == 0, last_tok, penult_tok, ts_floor,
                             static_mask, begin_mask)
        if temperature > 0.0:
            gumbel = -torch.log(torch.empty_like(masked).exponential_(generator=generator))
            next_tok = torch.argmax(masked + temperature * gumbel, dim=-1)
        else:
            next_tok = torch.argmax(masked, dim=-1)
        logp = torch.log_softmax(masked, dim=-1)
        tok_logp = logp.gather(-1, next_tok[:, None])[:, 0]

        next_tok = torch.where(finished, sp.eot, next_tok)
        sum_logprobs = sum_logprobs + torch.where(finished, 0.0, tok_logp)
        finished = finished | (next_tok == sp.eot)
        tokens[:, p + step] = next_tok
        ts_floor = update_ts_floor(ts_floor, next_tok, last_tok, sp)
        if step + 1 == max_len or bool(finished.all()):
            break
        logits, cache = model.decoder(next_tok[:, None], cross_kv, cache, pos=p + step,
                                      cross_s8=cross_s8)
        # penultimate stays the ts-sentinel while fewer than 2 tokens sampled
        penult_tok = ts_sentinel if step == 0 else last_tok
        last_tok = next_tok
        last_logits = logits[:, 0]

    sampled = tokens[:, p:]
    is_eot = sampled == sp.eot
    # first EOT; no EOT → full length
    lengths = torch.where(is_eot.any(-1), is_eot.int().argmax(-1), max_len)
    avg = sum_logprobs / torch.clamp(lengths + 1, min=1).float()
    return DecodeResult(tokens=tokens, lengths=lengths, sum_logprobs=sum_logprobs,
                        avg_logprobs=avg, no_speech_probs=no_speech_probs)


@torch.no_grad()
def detect_language_features(model: wm.Whisper, cross_kv: dict, sot: int,
                             lang_token_start: int, n_languages: int,
                             cross_s8: bool = False) -> torch.Tensor:
    """One decoder step from <|sot|>, restricted to language tokens:
    (B, n_languages) probabilities."""
    b = next(iter(cross_kv.values())).shape[1]
    device = next(iter(cross_kv.values())).device
    prompt = torch.full((b, 1), sot, dtype=torch.long, device=device)
    logits, _ = model.decoder(prompt, cross_kv, cross_s8=cross_s8)
    lang_logits = logits[:, 0, lang_token_start:lang_token_start + n_languages]
    return torch.softmax(lang_logits, dim=-1)


@torch.no_grad()
def greedy_decode(model: wm.Whisper, mel: torch.Tensor, prompt: torch.Tensor,
                  **kw) -> DecodeResult:
    """mel (B, n_mels, 3000) + prompt (B, P) → DecodeResult."""
    cross_kv = model.decoder.precompute_cross_kv(model.encoder(mel))
    return greedy_decode_features(model, cross_kv, prompt, **kw)


@torch.no_grad()
def detect_language(model: wm.Whisper, mel: torch.Tensor, specials) -> torch.Tensor:
    """mel (B, n_mels, 3000) → (B, n_languages) language probabilities."""
    cross_kv = model.decoder.precompute_cross_kv(model.encoder(mel))
    return detect_language_features(model, cross_kv, specials.sot, specials.sot + 1,
                                     specials.n_languages)
