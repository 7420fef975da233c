"""Beam search with Whisper's constraint grammar.

Port of turbo_whisper_workspace_tpu/decode/beam.py. The JAX package runs
the search as one `lax.while_loop` inside one jit; here it is one step
function over static buffers, as decode/greedy.py has: the prompt's
prefill and the first selection (with the begin mask) run eagerly, then
each step is the JAX loop's body (top-k, the finished and alive sets,
the gathers, one decoder call at a device-resident position), all
tensor ops updating the state in place (`utils/step_loop.py`). On a
CUDA device that step is captured once per call into a CUDA graph and
replayed, and the host reads the stop flag every STOP_EVERY steps; on
the CPU it runs eagerly with the flag read every step.

The stop is global, as the JAX loop's `cond`: every batch item holds K
finished hypotheses (or max_len selections ran). Items that saturated
earlier keep stepping until then, as in JAX, and their finished sets can
still change. A step that begins with the flag set leaves the result's
buffers and the step count as they are, so the steps a graphed run makes
past the stop, before the host reads the flag, change nothing.

Beams are flattened into the batch axis (B·K rows through the
decoder, row b·K + k); the alive and finished hypothesis sets are fixed
(B, K) tensors, and each step is top-k and gathers. The cross-KV stays
at batch B: the decoder feeds each item's K beam queries through one
read of it. Three self-KV cache modes, as in the JAX package:

* bf16 (quantize_cache=False): the prefill cache is repeated K times
  and physically regathered to the surviving beams every step, copied
  back into its own buffers (a graph's addresses are fixed);
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
from ..ops import whisper_ops as wo
from ..utils.step_loop import run_steps
from .rules import NEG_INF, DecodeRules, update_ts_floor

STOP_EVERY = 8      # graphed steps between the host's reads of the stop flag


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
    order of `jax.lax.top_k`; `torch.topk` promises none among ties).

    Each f32 value becomes a distinct int64 key: its bits mapped to an
    int32 of the same order (−0.0 taken as +0.0) times 2^32, plus the
    index's complement, so `torch.topk` over the keys meets no tie and
    returns what a stable descending sort would, without sorting the
    row, and with nothing a CUDA graph cannot capture."""
    n = x.shape[-1]
    bits = (x.float() + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    keys = ordered * (1 << 32) + (n - 1 - torch.arange(n, device=x.device))
    indices = (n - 1) - (torch.topk(keys, k, dim=-1).values & 0xFFFFFFFF)
    return x.gather(-1, indices), indices


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
    graphed: bool | None = None,
    timings: dict | None = None,
) -> BeamResult:
    """cross_s8: an int8 cross-KV is read by the s8×s8 cross-attention
    kernel (TranscriptionConfig.cross_attention_s8).

    graphed: None (the default) replays the step as a CUDA graph on a
    CUDA device and runs it eagerly, with the stop read every step, on
    the CPU. False runs the same step function eagerly with the card's
    cadence (the stop read every STOP_EVERY steps) on any device: on the
    card, the witness that the graph is that function, and the
    tensor-parallel decode, whose all-reduces a graph does not hold.
    True graphs it (CUDA only). `timings`, when given, receives the
    graph's `capture_s`, the loop's `loop_s` and the decoder calls after
    the prefill (`decode_forwards`)."""
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
    no_speech_probs = torch.softmax(prefill_logits[:, sot_index].float(), dim=-1)[
        :, sp.no_speech]

    # beam 0 alive, the rest at -inf, so that step 0 yields K distinct beams
    alive_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    alive_scores[:, 0] = 0.0
    ts_sent = torch.full((bk,), sp.timestamp_begin, dtype=torch.long, device=device)
    state = {
        "step": torch.zeros((), dtype=torch.long, device=device),    # selections made
        "finished": torch.zeros((), dtype=torch.bool, device=device),  # the global stop
        "alive_tokens": torch.cat(
            [prompt, torch.full((b, max_len), sp.eot, dtype=prompt.dtype, device=device)],
            1).repeat_interleave(k, dim=0).reshape(b, k, total),
        "alive_scores": alive_scores,
        "fin_tokens": torch.full((b, k, total), sp.eot, dtype=prompt.dtype, device=device),
        "fin_scores": torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
        "fin_lengths": torch.zeros((b, k), dtype=torch.long, device=device),
        "last_logits": prefill_logits[:, -1].float().repeat_interleave(k, dim=0),
        "last_tok": torch.zeros(bk, dtype=torch.long, device=device),
        "penult_tok": ts_sent,
        "ts_floor": ts_sent.clone(),
    }
    del prefill_logits
    if lane_cache:
        state["lane_map"] = torch.zeros((b, k, total), dtype=torch.int32, device=device)
    else:
        # regathered in place each step: state that a graph's warm-up
        # step must find restored
        state.update({f"cache.{name}": x for name, x in cache.items()})
    beam_ids = torch.arange(k, dtype=torch.int32, device=device).expand(b, k)[
        :, :, None].contiguous()
    row_base = torch.arange(b, device=device)[:, None] * k
    layer_base = torch.arange(dims.n_text_layer, device=device)[:, None] * bk

    def step(is_begin: bool = False) -> None:
        """The JAX loop's body: select at the state's step from the last
        logits, then feed the K new tokens of every item at their
        position. Begun with the stop set, it keeps the result's buffers
        and the step count."""
        s = state
        frozen = s["finished"]            # read below before the step updates it
        pos = s["step"] + p
        # cand = alive_scores + log_softmax(rules.apply(last_logits)): one
        # kernel on the card (ops/whisper_ops.py:whisper_logit_rules)
        _, _, cand = wo.whisper_logit_rules(
            s["last_logits"], rules, is_begin, s["last_tok"], s["penult_tok"], s["ts_floor"],
            static_mask, begin_mask, add=s["alive_scores"].reshape(bk))   # (B·K, V)
        # top 2K candidates per item, enough to fill K alive (non-EOT)
        # beams even if K of them are EOT. Two-stage exact top-k: any
        # global top-2K candidate is in its own beam's top-2K, so per-beam
        # top-2K then a merge over the K·2K survivors selects the same set
        s1, i1 = _top_k(cand, 2 * k)                              # (B·K, 2K)
        top_scores, m2 = _top_k(s1.reshape(b, 2 * k * k), 2 * k)  # (B, 2K)
        src_beam = m2 // (2 * k)
        tok = i1.reshape(b, 2 * k * k).gather(1, m2)
        is_eot = tok == sp.eot

        # finished set: merge the EOT candidates, keep the top K by score
        merged_scores = torch.cat(
            [s["fin_scores"], top_scores.masked_fill(~is_eot, NEG_INF)], 1)
        merged_tokens = torch.cat([s["fin_tokens"], _take_rows(s["alive_tokens"], src_beam)],
                                  1)
        merged_lengths = torch.cat([s["fin_lengths"], s["step"].expand(b, 2 * k)], 1)
        fin_scores, fin_idx = _top_k(merged_scores, k)

        # alive set: the best K non-EOT candidates
        alive_scores, alive_idx = _top_k(top_scores.masked_fill(is_eot, NEG_INF), k)
        alive_src = src_beam.gather(1, alive_idx)                 # (B, K)
        alive_tok = tok.gather(1, alive_idx)
        alive_tokens = _take_rows(s["alive_tokens"], alive_src)
        alive_tokens.index_copy_(2, pos.view(1), alive_tok[:, :, None].to(alive_tokens.dtype))

        for name, new in (("fin_scores", fin_scores),
                          ("fin_tokens", _take_rows(merged_tokens, fin_idx)),
                          ("fin_lengths", merged_lengths.gather(1, fin_idx)),
                          ("alive_scores", alive_scores), ("alive_tokens", alive_tokens)):
            s[name].copy_(torch.where(frozen, s[name], new))
        s["step"].add_((~frozen).long())
        s["finished"].copy_((s["fin_scores"] > NEG_INF / 2).all())

        # per-beam decoder state follows its source beam
        flat_src = (row_base + alive_src).reshape(bk)
        if lane_cache:
            # the cache stays; only the ancestry map is regathered, and the
            # row this step writes belongs to lane k by construction
            s["lane_map"].copy_(_take_rows(s["lane_map"], alive_src))
            s["lane_map"].index_copy_(2, pos.view(1), beam_ids)
        else:
            # physical regather on the flattened (L·B·K) axis, into place
            idx = (layer_base + flat_src[None]).reshape(-1)
            for x in cache.values():
                x.copy_(x.flatten(0, 1).index_select(0, idx).reshape(x.shape))
        last_tok_g = s["last_tok"][flat_src]
        next_tok = alive_tok.reshape(bk)
        s["ts_floor"].copy_(update_ts_floor(s["ts_floor"][flat_src], next_tok, last_tok_g, sp))
        # penultimate stays the ts-sentinel while fewer than 2 tokens sampled
        if not is_begin:
            s["penult_tok"].copy_(last_tok_g)
        s["last_tok"].copy_(next_tok)
        logits, _ = model.decoder(next_tok[:, None], cross_kv, cache, pos=pos, beam=k,
                                  lane_map=s.get("lane_map"), cross_s8=cross_s8)
        s["last_logits"].copy_(logits[:, 0])

    step(is_begin=True)
    forwards = 1 + run_steps(step, state, max_len - 1, STOP_EVERY, graphed, None, timings)
    if timings is not None:
        timings["decode_forwards"] = forwards

    # nothing finished in a slot (max_len hit): fall back to the alive hypothesis
    fin_scores, fin_tokens, fin_lengths = (state[name] for name in (
        "fin_scores", "fin_tokens", "fin_lengths"))
    any_fin = fin_scores > NEG_INF / 2
    fin_scores = torch.where(any_fin, fin_scores, state["alive_scores"])
    fin_tokens = torch.where(any_fin[:, :, None], fin_tokens, state["alive_tokens"])
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
