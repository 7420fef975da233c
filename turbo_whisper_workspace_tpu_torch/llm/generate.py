"""Autoregressive generation for the Llama LM.

Port of turbo_whisper_workspace_tpu/llm/generate.py. The JAX package
runs the loop as one `lax.while_loop` inside one jit; here it is a
Python loop over decode steps with one host sync per step
(`finished.all()`), which stops when every row has emitted an EOS token
or after max_len steps, and skips the forward after the last sampled
token (its logits would be discarded).

Sampling is gumbel-max, argmax(logits + T·G): an exact argmax at T = 0
and an exact categorical draw at T > 0, with G drawn from the caller's
`torch.Generator` (seeded 0 when none is given). Its draws differ from
the JAX package's `rbg` key, so sampled tokens do not match it; fed the
same noise, `sample` picks the same token.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..models import llama as lm


class GenResult(NamedTuple):
    tokens: torch.Tensor     # (B, P + max_len) int64, EOS-padded after the end
    lengths: torch.Tensor    # (B,) sampled tokens before the first EOS


def sample(logits: torch.Tensor, temperature: float,
           gumbel: torch.Tensor | None) -> torch.Tensor:
    """One gumbel-max step over (B, V) f32 logits → (B,) tokens."""
    if temperature > 0.0:
        logits = logits + temperature * gumbel
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def generate_tokens(
    params: dict,
    dims: lm.LlamaDims,
    prompt: torch.Tensor,              # (B, P) int64
    *,
    max_len: int = 256,
    temperature: float = 0.0,
    eos_tokens: tuple = (),
    generator: torch.Generator | None = None,
    timings: dict | None = None,
) -> GenResult:
    """Prefill the prompt, then sample up to max_len tokens. `timings`,
    when given, receives the prefill's and the decode loop's wall seconds
    (each ending in a device sync) and the number of decode forwards."""
    device = prompt.device
    b, p = prompt.shape
    total = p + max_len
    if total > dims.max_ctx:
        raise ValueError(f"prompt {p} + max_len {max_len} exceeds max_ctx {dims.max_ctx}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device).manual_seed(0)
    eos = torch.tensor(eos_tokens or (0,), dtype=prompt.dtype, device=device)
    pad_tok = int(eos[0])

    t0 = time.perf_counter()
    cache = lm.init_kv_cache(dims, b, max_len=total, dtype=params["token_emb"].dtype,
                             device=device)
    prefill_logits, cache = lm.forward(params, dims, prompt, cache, pos=0)
    tokens = torch.cat([prompt, torch.full((b, max_len), pad_tok, dtype=prompt.dtype,
                                           device=device)], 1)
    last_logits = prefill_logits[:, -1].float()
    del prefill_logits
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    if timings is not None:
        _sync(device)
        timings["prefill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    forwards = 0

    for step in range(max_len):
        gumbel = None
        if temperature > 0.0:
            gumbel = -torch.log(torch.empty_like(last_logits).exponential_(generator=generator))
        next_tok = sample(last_logits, temperature, gumbel)
        next_tok = torch.where(finished, pad_tok, next_tok)
        finished = finished | torch.isin(next_tok, eos)
        tokens[:, p + step] = next_tok
        if step + 1 == max_len or bool(finished.all()):
            break
        logits, cache = lm.forward(params, dims, next_tok[:, None], cache, pos=p + step)
        forwards += 1
        last_logits = logits[:, 0].float()

    if timings is not None:
        _sync(device)
        timings["decode_s"] = time.perf_counter() - t0
        timings["decode_forwards"] = forwards
    is_eos = torch.isin(tokens[:, p:], eos)
    lengths = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), max_len)
    return GenResult(tokens=tokens, lengths=lengths)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
