"""Beam search with Whisper's constraint grammar.

Port of turbo_whisper_workspace_tpu/decode/beam.py. The JAX package runs
the search as one `lax.while_loop` inside one jit; here it is a Python
loop over decoder steps with one host sync per step, for the stop test
(every batch item holds K finished hypotheses), as decode/greedy.py has.

Beams are flattened into the batch axis (B·K rows through the
decoder, row b·K + k); the alive and finished hypothesis sets are fixed
(B, K) tensors, and each step is top-k and gathers. The cross-KV stays
at batch B: the decoder feeds each item's K beam queries through one
read of it. Three self-KV cache modes, as in the JAX package:

* bf16 (quantize_cache=False): the prefill cache is repeated K times
  and physically regathered to the surviving beams every step;
* int8 with lane_cache=False: the same, over the int8 cache;
* int8 lanes (quantize_cache=True, the default lane_cache=True): the
  cache is never moved. Lane l keeps what beam slot l wrote at each
  position; a (B, K, T) int32 lane_map, the only state regathered,
  names the lane each beam reads at each position.

Semantics follow openai/whisper's BeamSearchDecoder and
MaximumLikelihoodRanker: sum-logprob scores during the search, EOT
hypotheses retired into the finished set, and the final choice by
length-normalised score. Every top-k goes through `_top_k`, which puts
the lower index first among equal values as `jax.lax.top_k` does; the
−1e30 scores of dead beams and empty finished slots tie exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import whisper as wm
from .rules import NEG_INF, DecodeRules, update_ts_floor


class BeamResult(NamedTuple):
    tokens: torch.Tensor           # (B, P + max_len) best hypothesis, EOT-padded
    lengths: torch.Tensor          # (B,) sampled length of the best hypothesis
    sum_logprobs: torch.Tensor     # (B,)
    avg_logprobs: torch.Tensor     # (B,)
    no_speech_probs: torch.Tensor  # (B,) P(<|nospeech|>) at the SOT position
    all_tokens: torch.Tensor       # (B, K, P + max_len) the finished set
    all_scores: torch.Tensor       # (B, K)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, in
    descending order, the lower index first among equal values (the
    order of `jax.lax.top_k`; `torch.topk` promises none)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) → (B, M, ...): row idx[b, m] of item b."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


@torch.no_grad()
def beam_decode_features(
    model: wm.Whisper,
    cross_kv: dict,
    prompt: torch.Tensor,              # (B, P) int64
    *,
    rules: DecodeRules,
    beam_size: int = 5,
    max_len: int = 224,
    sot_index: int = 0,
    quantize_cache: bool = False,
    lane_cache: bool = True,
    cross_s8: bool = False,
) -> BeamResult:
    """cross_s8: an int8 cross-KV is read by the s8×s8 cross-attention
    kernel (TranscriptionConfig.cross_attention_s8)."""
    dims = model.dims
    sp = rules.specials
    device = prompt.device
    b, p = prompt.shape
    k = beam_size
    bk = b * k
    total = p + max_len
    if total > dims.n_text_ctx:
        raise ValueError(f"prompt {p} + max_len {max_len} exceeds n_text_ctx "
                         f"{dims.n_text_ctx}")
    lane_cache = lane_cache and quantize_cache
    static_mask = rules.static_mask(device)
    begin_mask = rules.begin_mask(device)

    # prefill once at B rows: every beam shares the prompt
    cache = wm.init_kv_cache(dims, b, max_len=total, dtype=model.dtype, device=device,
                             quantize=quantize_cache, n_head=model.decoder.n_head)
    prefill_logits, cache = model.decoder(prompt, cross_kv, cache, pos=0,
                                         cross_s8=cross_s8)
    if lane_cache:
        cache = wm.beam_lane_cache(cache, k)
    else:
        cache = {name: x.repeat_interleave(k, dim=1) for name, x in cache.items()}
    lane_map = torch.zeros((b, k, total), dtype=torch.int32, device=device)
    no_speech_probs = torch.softmax(prefill_logits[:, sot_index].float(), dim=-1)[
        :, sp.no_speech]

    alive_tokens = torch.cat(
        [prompt, torch.full((b, max_len), sp.eot, dtype=prompt.dtype, device=device)],
        1).repeat_interleave(k, dim=0).reshape(b, k, total)
    # beam 0 alive, the rest at -inf, so that step 0 yields K distinct beams
    alive_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    alive_scores[:, 0] = 0.0
    last_logits = prefill_logits[:, -1].float().repeat_interleave(k, dim=0)
    ts_sent = torch.full((bk,), sp.timestamp_begin, dtype=torch.long, device=device)
    last_tok = torch.zeros(bk, dtype=torch.long, device=device)
    penult_tok = ts_sent
    ts_floor = ts_sent
    fin_tokens = torch.full((b, k, total), sp.eot, dtype=prompt.dtype, device=device)
    fin_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    fin_lengths = torch.zeros((b, k), dtype=torch.long, device=device)
    beam_ids = torch.arange(k, dtype=torch.int32, device=device).expand(b, k)
    row_base = torch.arange(b, device=device)[:, None] * k
    layer_base = torch.arange(dims.n_text_layer, device=device)[:, None] * bk

    for step in range(max_len):
        masked = rules.apply(last_logits, step == 0, last_tok, penult_tok, ts_floor,
                             static_mask, begin_mask)
        # top 2K candidates per item, enough to fill K alive (non-EOT)
        # beams even if K of them are EOT. Two-stage exact top-k: any
        # global top-2K candidate is in its own beam's top-2K, so per-beam
        # top-2K then a merge over the K·2K survivors selects the same set
        logp = torch.log_softmax(masked, dim=-1)                  # (B·K, V)
        cand = alive_scores.reshape(bk, 1) + logp
        s1, i1 = _top_k(cand, 2 * k)                              # (B·K, 2K)
        top_scores, m2 = _top_k(s1.reshape(b, 2 * k * k), 2 * k)  # (B, 2K)
        src_beam = m2 // (2 * k)
        tok = i1.reshape(b, 2 * k * k).gather(1, m2)
        is_eot = tok == sp.eot
        pos = p + step

        # finished set: merge the EOT candidates, keep the top K by score
        merged_scores = torch.cat([fin_scores, top_scores.masked_fill(~is_eot, NEG_INF)], 1)
        merged_tokens = torch.cat([fin_tokens, _take_rows(alive_tokens, src_beam)], 1)
        merged_lengths = torch.cat([fin_lengths, torch.full_like(m2, step)], 1)
        fin_scores, fin_idx = _top_k(merged_scores, k)
        fin_tokens = _take_rows(merged_tokens, fin_idx)
        fin_lengths = merged_lengths.gather(1, fin_idx)

        # alive set: the best K non-EOT candidates
        alive_scores, alive_idx = _top_k(top_scores.masked_fill(is_eot, NEG_INF), k)
        alive_src = src_beam.gather(1, alive_idx)                 # (B, K)
        alive_tok = tok.gather(1, alive_idx)
        alive_tokens = _take_rows(alive_tokens, alive_src)
        alive_tokens[:, :, pos] = alive_tok

        if step + 1 == max_len or bool((fin_scores > NEG_INF / 2).all()):
            break

        # per-beam decoder state follows its source beam
        flat_src = (row_base + alive_src).reshape(bk)
        if lane_cache:
            # the cache stays; only the ancestry map is regathered, and the
            # row this step writes belongs to lane k by construction
            lane_map = _take_rows(lane_map, alive_src)
            lane_map[:, :, pos] = beam_ids
        else:
            # physical regather on the flattened (L·B·K) axis
            idx = (layer_base + flat_src[None]).reshape(-1)
            cache = {name: x.flatten(0, 1).index_select(0, idx).reshape(x.shape)
                     for name, x in cache.items()}
        last_tok_g = last_tok[flat_src]
        next_tok = alive_tok.reshape(bk)
        ts_floor = update_ts_floor(ts_floor[flat_src], next_tok, last_tok_g, sp)
        penult_tok = ts_sent if step == 0 else last_tok_g
        last_tok = next_tok
        logits, cache = model.decoder(next_tok[:, None], cross_kv, cache, pos=pos, beam=k,
                                      lane_map=lane_map if lane_cache else None,
                                      cross_s8=cross_s8)
        last_logits = logits[:, 0]

    # nothing finished in a slot (max_len hit): fall back to the alive hypothesis
    any_fin = fin_scores > NEG_INF / 2
    fin_scores = torch.where(any_fin, fin_scores, alive_scores)
    fin_tokens = torch.where(any_fin[:, :, None], fin_tokens, alive_tokens)
    fin_lengths = torch.where(any_fin, fin_lengths, max_len)

    # MaximumLikelihoodRanker: maximise sum_logprob / (length + 1)
    best = torch.argmax(fin_scores / (fin_lengths.float() + 1.0), dim=1, keepdim=True)
    best_scores = fin_scores.gather(1, best)[:, 0]
    best_lengths = fin_lengths.gather(1, best)[:, 0]
    return BeamResult(
        tokens=_take_rows(fin_tokens, best)[:, 0],
        lengths=best_lengths,
        sum_logprobs=best_scores,
        avg_logprobs=best_scores / (best_lengths.float() + 1.0),
        no_speech_probs=no_speech_probs,
        all_tokens=fin_tokens,
        all_scores=fin_scores,
    )


def beam_decode(model: wm.Whisper, mel: torch.Tensor, prompt: torch.Tensor,
                **kw) -> BeamResult:
    """mel (B, n_mels, 3000) → encoder → dense cross-KV → beam search."""
    with torch.no_grad():
        cross_kv = model.decoder.precompute_cross_kv(model.encoder(mel))
    return beam_decode_features(model, cross_kv, prompt, **kw)
