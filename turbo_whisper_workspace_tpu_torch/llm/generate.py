"""Autoregressive generation for the decoder-only LMs.

Port of turbo_whisper_workspace_tpu/llm/generate.py. The JAX package
runs the loop as one `lax.while_loop` inside one jit; here it is one
step function over fixed shapes (`utils/step_loop.py`): the prefill and
the first sample run eagerly, then each step is a forward of the last
token at a device-resident position (the family's `forward` with a
tensor `pos`: `models/llama.py`, or `models/deepseek_v3.py`, which the
JAX package does not have; `family` picks it by the dims' type), the
sample, and the token written by index, all updating
static buffers in place. On a CUDA device that step is captured once
per call into a CUDA graph and replayed, and the host reads the stop
flag every STOP_EVERY steps; on the CPU it runs eagerly with the stop
read every step. The loop ends when every row has emitted an EOS token
or after max_len sampled tokens; finished rows stay frozen (EOS-padded),
so steps past the last row's EOS change nothing.

Sampling is gumbel-max, argmax(logits + T·G): an exact argmax at T = 0
and an exact categorical draw at T > 0, with G drawn from the caller's
`torch.Generator` (seeded 0 when none is given; registered with the
graph on the card). Its draws differ from the JAX package's `rbg` key,
so sampled tokens do not match it; fed the same noise, `sample` picks
the same token.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..models import deepseek_v3 as ds
from ..models import llama as lm
from ..utils import profiling
from ..utils.step_loop import run_steps

STOP_EVERY = 4      # graphed steps between the host's reads of the stop flag


def family(dims):
    """The model module the dims describe: `models/deepseek_v3.py` for
    `DeepseekV3Dims`, else `models/llama.py`. Both give `forward`,
    `init_kv_cache`, `fuse_siblings`, `params_from_hf_state_dict` and
    `QUANT_KEYS`."""
    return ds if isinstance(dims, ds.DeepseekV3Dims) else lm


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
    dims: lm.LlamaDims | ds.DeepseekV3Dims,
    prompt: torch.Tensor,              # (B, P) int64
    *,
    max_len: int = 256,
    temperature: float = 0.0,
    eos_tokens: tuple = (),
    generator: torch.Generator | None = None,
    timings: dict | None = None,
    graphed: bool | None = None,
) -> GenResult:
    """Prefill the prompt, then sample up to max_len tokens. `timings`,
    when given, receives the prefill's (the `llm.prefill` span's) and the
    decode loop's wall seconds (each ending in a device sync), the number
    of decode forwards and the graph's `capture_s` (inside `decode_s`).

    graphed: None (the default) replays the step as a CUDA graph on a
    CUDA device and runs it eagerly, with the stop read every step, on
    the CPU; False runs the same step function eagerly with the card's
    cadence (the stop read every STOP_EVERY steps), the witness that the
    graph is that function; True graphs it (CUDA only)."""
    device = prompt.device
    b, p = prompt.shape
    total = p + max_len
    if total > dims.max_ctx:
        raise ValueError(f"prompt {p} + max_len {max_len} exceeds max_ctx {dims.max_ctx}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device).manual_seed(0)
    eos = torch.tensor(eos_tokens or (0,), dtype=prompt.dtype, device=device)
    model = family(dims)
    pad_tok = int(eos_tokens[0]) if eos_tokens else 0

    with profiling.span("llm.prefill", timed=timings is not None) as span:
        cache = model.init_kv_cache(dims, b, max_len=total, dtype=params["token_emb"].dtype,
                                    device=device)
        prefill_logits, cache = model.forward(params, dims, prompt, cache, pos=0)
        last_logits = prefill_logits[:, -1].float()
        del prefill_logits
        state = {
            "tokens": torch.cat([prompt, torch.full((b, max_len), pad_tok, dtype=prompt.dtype,
                                                    device=device)], 1),
            "step": torch.zeros((), dtype=torch.long, device=device),    # tokens sampled
            "last_tok": torch.zeros(b, dtype=prompt.dtype, device=device),
            "finished": torch.zeros(b, dtype=torch.bool, device=device),
        }
        if timings is not None:
            _sync(device)
    if timings is not None:
        timings["prefill_s"] = span.seconds
    t0 = time.perf_counter()

    def sample_into_state(logits: torch.Tensor) -> None:
        """Sample token p + step from (B, V) f32 logits into the state."""
        gumbel = None
        if temperature > 0.0:
            gumbel = -torch.log(torch.empty_like(logits).exponential_(generator=generator))
        next_tok = sample(logits, temperature, gumbel)
        finished = state["finished"]
        next_tok = torch.where(finished, pad_tok, next_tok)
        finished.logical_or_((next_tok[:, None] == eos[None]).any(-1))
        state["tokens"].index_copy_(1, (state["step"] + p).view(1), next_tok[:, None])
        state["last_tok"].copy_(next_tok)
        state["step"].add_(1)

    def step() -> None:
        """Forward the last sampled token at its position, sample the next."""
        logits, _ = model.forward(params, dims, state["last_tok"][:, None], cache,
                                  pos=state["step"] + (p - 1))
        sample_into_state(logits[:, 0].float())

    sample_into_state(last_logits)
    del last_logits
    forwards = run_steps(step, state, max_len - 1, STOP_EVERY, graphed,
                         generator if temperature > 0.0 else None, timings)

    if timings is not None:
        _sync(device)
        timings["decode_s"] = time.perf_counter() - t0
        timings["decode_forwards"] = forwards
    tokens = state["tokens"]
    is_eos = torch.isin(tokens[:, p:], eos)
    lengths = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), max_len)
    return GenResult(tokens=tokens, lengths=lengths)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
