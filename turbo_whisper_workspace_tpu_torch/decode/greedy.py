"""KV-cached greedy / sampled decode.

Port of turbo_whisper_workspace_tpu/decode/greedy.py. The JAX package
runs the loop as one `lax.while_loop` inside one jit; here it is one
step function over fixed shapes: the prompt's prefill and the first
sample (with the begin mask) run eagerly, then each step is a decoder
call at a device-resident position over the whole preallocated cache,
the token rules with the sample (`ops/whisper_ops.py:
whisper_logit_rules`, one kernel on the card) and the bookkeeping, all
updating static buffers in place (`utils/step_loop.py`). On
a CUDA device that step is captured once per call into a CUDA graph and
replayed, and the host reads the stop flag every STOP_EVERY steps; on
the CPU it runs eagerly with the stop read every step. The loop ends
when every row has emitted EOT or after max_len sampled tokens; rows
that finished stay frozen (EOT, their log-probabilities unchanged), so
the steps a graphed run makes past the last row's EOT change nothing.
Returned bookkeeping mirrors openai/whisper's DecodingResult fields the
long-form fallbacks need (avg_logprob, no_speech_prob). `greedy_decode`
and `detect_language` take log-mel input: the encoder, then the dense
cross-KV, then the `*_features` function, as the JAX helpers do. The
span `greedy.prefill` covers the cache's set-up, the
prompt's pass and the first sample; the loop's spans are `run_steps`'.

Sampling at temperature T > 0 is gumbel-max, argmax(logits + T·G), with
G drawn from the caller's `torch.Generator` (registered with the graph
on the card, so each replay draws anew); its draws differ from the JAX
package's `rbg` key, so sampled tokens do not match it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import whisper as wm
from ..ops import whisper_ops as wo
from ..utils import profiling
from ..utils.step_loop import run_steps
from .rules import DecodeRules, update_ts_floor

STOP_EVERY = 8      # graphed steps between the host's reads of the stop flag


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
    graphed: bool | None = None,
    timings: dict | None = None,
) -> DecodeResult:
    """cross_s8: an int8 cross-KV is read by the s8×s8 cross-attention
    kernel (TranscriptionConfig.cross_attention_s8).

    graphed: None (the default) replays the step as a CUDA graph on a
    CUDA device and runs it eagerly, with the stop read every step, on
    the CPU. False runs the same step function eagerly with the card's
    cadence (the stop read every STOP_EVERY steps) on any device: on the
    card, the witness that the graph is that function, and the
    tensor-parallel decode, whose all-reduces a graph does not hold.
    True graphs it (CUDA only). `timings`, when given, receives the
    graph's `capture_s` and the decoder calls after the prefill
    (`decode_forwards`)."""
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

    # the prompt's pass and the first sample, with the cache and state they fill
    with profiling.span("greedy.prefill"):
        cache = wm.init_kv_cache(dims, b, max_len=total, dtype=model.dtype,
                                 device=device, n_head=model.decoder.n_head)
        static_mask = rules.static_mask(device)
        begin_mask = rules.begin_mask(device)

        # prefill the prompt in one pass
        prefill_logits, cache = model.decoder(prompt, cross_kv, cache, pos=0,
                                             cross_s8=cross_s8)
        no_speech_probs = torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, sp.no_speech]

        # Pairing state looks at SAMPLED tokens only (openai/whisper): before
        # anything is sampled, "last" is a non-timestamp sentinel and
        # "penultimate" counts as a timestamp.
        ts_sentinel = torch.full((b,), sp.timestamp_begin, dtype=torch.long, device=device)
        state = {
            "tokens": torch.cat([prompt, torch.full((b, max_len), sp.eot, dtype=prompt.dtype,
                                                    device=device)], 1),
            "step": torch.zeros((), dtype=torch.long, device=device),    # tokens sampled
            "last_tok": torch.zeros(b, dtype=torch.long, device=device),
            "penult_tok": ts_sentinel.clone(),
            "ts_floor": ts_sentinel.clone(),
            "finished": torch.zeros(b, dtype=torch.bool, device=device),
            "sum_logprobs": torch.zeros(b, dtype=torch.float32, device=device),
        }

        def sample(logits: torch.Tensor, is_begin: bool) -> None:
            """Sample token p + step from (B, V) logits into the state."""
            gumbel = None
            if temperature > 0.0:
                gumbel = -torch.log(torch.empty_like(logits).exponential_(generator=generator))
            # the rules, the argmax of masked (+ T·gumbel) and its log_softmax
            next_tok, tok_logp, _ = wo.whisper_logit_rules(
                logits, rules, is_begin, state["last_tok"], state["penult_tok"], state["ts_floor"],
                static_mask, begin_mask, gumbel, temperature)

            finished = state["finished"]
            next_tok = torch.where(finished, sp.eot, next_tok)
            state["sum_logprobs"].add_(torch.where(finished, 0.0, tok_logp))
            finished.logical_or_(next_tok == sp.eot)
            state["tokens"].index_copy_(1, (state["step"] + p).view(1), next_tok[:, None])
            state["ts_floor"].copy_(update_ts_floor(state["ts_floor"], next_tok,
                                                    state["last_tok"], sp))
            # penultimate stays the ts-sentinel while fewer than 2 tokens sampled
            if not is_begin:
                state["penult_tok"].copy_(state["last_tok"])
            state["last_tok"].copy_(next_tok)
            state["step"].add_(1)

        def step() -> None:
            """Feed the last sampled token at its position, sample the next."""
            logits, _ = model.decoder(state["last_tok"][:, None], cross_kv, cache,
                                      pos=state["step"] + (p - 1), cross_s8=cross_s8)
            sample(logits[:, 0], is_begin=False)

        sample(prefill_logits[:, -1].contiguous(), is_begin=True)
        del prefill_logits

    forwards = run_steps(step, state, max_len - 1, STOP_EVERY, graphed,
                         generator if temperature > 0.0 else None, timings)
    if timings is not None:
        timings["decode_forwards"] = forwards

    tokens, sum_logprobs = state["tokens"], state["sum_logprobs"]
    is_eot = tokens[:, p:] == sp.eot
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
