"""The enrichment stage: one caller, closed loop, each call one
conversation of the mix's pool through `AudioProcessingPipeline`'s three
stage methods in order (speaker names, summary, topics), with the
benchmark's Llama-architecture model injected by `llm_helper.set_llm`.

Every `greedy_every`-th conversation of the pool runs its three calls at
temperature 0: greedy tokens are what the check can judge against the
reference. Work of a call: the tokens the model generated.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.lib import costs, gaps, traffic, weights
from port_bench.reference import llama as ref

PORT_QUANTIZATION = {"body_bits": 4, "group": 128, "head_bits": 8, "decode_activation_bits": 8}


def dims(cfg: dict):
    from turbo_whisper_workspace_tpu_torch.models.llama import LlamaDims

    return LlamaDims(n_vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
                     n_layer=cfg["num_hidden_layers"], n_head=cfg["num_attention_heads"],
                     n_kv_head=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
                     rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
                     max_ctx=cfg["max_position_embeddings"])


def build_params(cfg: dict, seed: int, device) -> dict:
    """The port's Q4 parameter dict from the benchmark's weights, drawn
    and quantized (`ops/quant.quantize_tree`, bits=4) a layer at a time."""
    from turbo_whisper_workspace_tpu_torch.ops import quant

    if cfg["quantization"] != PORT_QUANTIZATION:
        raise ValueError(f"the port's Q4 point is {PORT_QUANTIZATION}, the configuration "
                         f"states {cfg['quantization']}")
    ones = torch.ones(cfg["hidden_size"], dtype=weights.DTYPE, device=device)
    blocks = []
    for layer in range(cfg["num_hidden_layers"]):
        raw = weights.llama_layer(cfg, seed, layer, device)
        block = quant.quantize_tree({p: {"w": raw[p]} for p in weights.PROJECTIONS}, bits=4)
        del raw
        block.update(attn_norm={"scale": ones}, mlp_norm={"scale": ones})
        blocks.append(block)
    ends = weights.llama_ends(cfg, seed, device)
    head = quant.quantize_tree({"lm_head": {"w": ends["lm_head"]}}, bits=4)["lm_head"]
    return {"token_emb": ends["token_emb"].clone(), "blocks": blocks,
            "norm": {"scale": ones}, "lm_head": head}


class GenerateTap:
    """Wraps the port's `llm/generate.generate_tokens` (TorchLlama.generate
    looks it up at each call): keeps each call's prompt, tokens, lengths,
    temperature and timings."""

    def __init__(self):
        from turbo_whisper_workspace_tpu_torch.llm import generate

        self.module, self.original = generate, generate.generate_tokens
        self.current: list = []
        generate.generate_tokens = self._generate

    def _generate(self, params, dims, prompt, **kw):
        kw.setdefault("timings", {})
        res = self.original(params, dims, prompt, **kw)
        self.current.append({"prompt": prompt, "tokens": res.tokens, "lengths": res.lengths,
                             "temperature": kw.get("temperature", 0.0),
                             "max_len": kw.get("max_len", 256), "timings": kw["timings"]})
        return res

    def take(self) -> list:
        out, self.current = self.current, []
        return out

    def close(self) -> None:
        self.module.generate_tokens = self.original


def served_gaps(logits: list, samples: list, judged: list | None = None) -> list:
    """At each generated position of each sample, by how much the
    reference's best token beats the judged one (the served one unless
    `judged` gives others)."""
    out = []
    for i, (lg, (tokens, p)) in enumerate(zip(logits, samples)):
        tok = judged[i] if judged is not None else torch.tensor(tokens[p:], device=lg.device)
        rows = lg[:len(tok)]
        out.append(rows.amax(-1) - rows.gather(-1, tok[:, None])[:, 0])
    return out


def check(cfg: dict, seed: int, device, samples: list, limits: dict,
          control: str | None = None) -> list[dict]:
    """The number compared, `mean_gap`: the mean, over the served tokens
    of the sampled greedy calls, of the gap by which the reference's best
    token beats the served one (its widest gap and other summaries
    beside it). control "int4_activations": judge instead, at the same
    positions, the token the reference with int4 decode activations (one
    step below the configured W4A8) puts first."""
    t0 = time.perf_counter()
    logits = ref.served_logits(cfg, seed, samples, device)
    judged = None
    if control == "int4_activations":
        lower = ref.served_logits(cfg, seed, samples, device, act_bits=4)
        judged = [lg[:len(toks) - p].argmax(-1) for lg, (toks, p) in zip(lower, samples)]
    stats = gaps.summary(served_gaps(logits, samples, judged))
    return [{"name": "mean_gap", "value": stats["mean"], "limit": limits["mean_gap"], **stats,
             "seconds": time.perf_counter() - t0}]


def generated(rec: dict) -> int:
    """Tokens a call generated: those before the first EOS, and the EOS."""
    return min(int(rec["lengths"][0]) + 1, rec["max_len"])


class Entry:
    def __init__(self, ctx):
        from turbo_whisper_workspace_tpu_torch.config import LLMConfig, PipelineConfig
        from turbo_whisper_workspace_tpu_torch.llm import llm_helper
        from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
            AudioProcessingPipeline)

        self.ctx = ctx
        mix = ctx.traffic
        self.helper = llm_helper
        self.llm = llm_helper.TorchLlama(build_params(ctx.config, ctx.seed, ctx.device),
                                         dims(ctx.config), device=ctx.device)
        llm_helper.set_llm(self.llm)
        stage = dict(mix["llm"])
        self.pipes = {t: AudioProcessingPipeline(PipelineConfig(llm=LLMConfig(**{
            **stage, **({"temperature_names": 0.0, "temperature_summary": 0.0} if t else {})})),
            device=ctx.device) for t in (False, True)}
        rng = np.random.default_rng([ctx.seed, 1000])
        self.pool = [traffic.conversation(sizes, rng)
                     for sizes in traffic.conversation_sizes(mix)]
        self.greedy = [k % mix["greedy_every"] == 0 for k in range(len(self.pool))]
        self.tap = GenerateTap()
        self.calls: dict[int, list] = {}

    def run(self, k: int) -> None:
        pipe, segs = self.pipes[self.greedy[k]], self.pool[k]
        pipe.identify_speaker_names(segs)
        pipe.generate_summary(segs)
        pipe.extract_topics(segs)

    def warm_up(self) -> None:
        self.run(0)
        self.tap.take()

    def record(self, index: int, k: int) -> dict:
        recs = self.tap.take()
        if len(recs) != 3:
            raise RuntimeError(f"conversation {k}: {len(recs)} model calls, 3 expected")
        for r in recs:
            r["greedy"] = self.greedy[k]
        self.calls[index] = recs
        # where a slow call's time went, for the run's stderr record
        phases = {key: sum(r["timings"].get(key, 0.0) for r in recs)
                  for key in ("prefill_s", "capture_s", "loop_s")}
        return {"tokens": sum(generated(r) for r in recs), "greedy": self.greedy[k],
                "phases_s": phases}

    def call_flops(self, index: int, k: int) -> float:
        return sum(costs.llama_generate_flops(self.ctx.config, r["prompt"].shape[1],
                                              r["timings"]["decode_forwards"])
                   for r in self.calls[index])

    def timings(self, key: str) -> list[float]:
        return [r["timings"][key] for recs in self.calls.values() for r in recs]

    def samples(self, calls) -> list[tuple[list[int], int]]:
        """The greedy model calls the check compares: every one of those
        the window finished (prompt + generated tokens, prompt length)."""
        recs = [r for c in calls for r in self.calls[c.index] if r["greedy"]]
        if not recs:
            raise RuntimeError("no greedy conversation finished in the window")
        return [(r["tokens"][0, :r["prompt"].shape[1] + generated(r)].tolist(),
                 r["prompt"].shape[1]) for r in recs]

    def check(self, calls) -> list[dict]:
        samples = self.samples(calls)
        self.release()
        return check(self.ctx.config, self.ctx.seed, self.ctx.device, samples,
                     self.ctx.cell["limits"])

    def release(self) -> None:
        """Frees the port's state: the model, the taps."""
        self.tap.close()
        self.helper.set_llm(None)
        if self.helper._unload_timer is not None:
            self.helper._unload_timer.cancel()
        self.llm = self.pipes = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass
