"""The enrichment stage on a DeepSeek-V3-architecture model
(Moonlight-16B-A3B at Q4): entries/llm_enrich.py's conversations, calls
and work, with the model the configuration describes injected by
`llm_helper.set_llm`: the benchmark's weights drawn a layer at a time in
the published checkpoint's layout (`lib/deepseek_v3.py`), loaded by the
program's own loader (models/deepseek_v3.py:block_from_hf) and quantized
at its Q4 point (`quantize_tree` with the family's keys), then served by
`TorchLlama` through the pipeline's stage methods.

The check is llm_enrich's `mean_gap` over the window's greedy calls,
against `reference/deepseek_v3.py`, twice: routed on the reference's
own scores, and routed on the experts the program chose while serving
(`RoutesTap` hands the program's router kernel a log of its own for
each call, which the kernel writes on the card with no launch of its
own; the program keeps no such log). At random weights
the routing is where bf16 and f32 part most: a flip at one layer turns a
token's later layers into other states, so the first number carries
that spread and the second compares all else tightly. Beside them, a
diagnostic with no limit: `routing_differs`, the share of (token, MoE
layer) choices at the served positions on which the program and the
reference differ.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.entries import llm_enrich
from port_bench.lib import deepseek_v3 as dv3
from port_bench.lib import gaps, traffic
from port_bench.reference import deepseek_v3 as ref

PORT_QUANTIZATION = {"body_bits": 4, "group": 128, "expert_down_group": 64, "head_bits": 8,
                     "decode_activation_bits": 8}


def dims(cfg: dict):
    from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds

    return ds.dims_from_hf_config(cfg)


def build_params(cfg: dict, seed: int, device) -> dict:
    """The program's Q4 parameter dict from the benchmark's weights, drawn,
    loaded and quantized a layer at a time."""
    from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds
    from turbo_whisper_workspace_tpu_torch.ops import quant

    point = {k: cfg["quantization"][k] for k in PORT_QUANTIZATION}
    if point != PORT_QUANTIZATION:
        raise ValueError(f"the program's Q4 point is {PORT_QUANTIZATION}, the configuration "
                         f"states {cfg['quantization']}")
    d = dims(cfg)
    blocks = []
    for i in range(d.n_layer):
        raw = dv3.layer(cfg, seed, i, device)
        block = ds.block_from_hf(raw, d, i, dtype=dv3.weights.DTYPE, device=device)
        del raw
        block = quant.quantize_tree(block, keys=ds.QUANT_KEYS, bits=4)
        if "experts" in block:
            groups = {n: d_in // block["experts"][n]["scale4"].shape[-2] for n, d_in in (
                ("gate", d.d_model), ("down", d.moe_d_ff))}
            if groups != {"gate": point["group"], "down": point["expert_down_group"]}:
                raise ValueError(f"the experts' int4 groups are {groups}")
        blocks.append(block)
    ends = dv3.ends(cfg, seed, device)
    head = quant.quantize_tree({"lm_head": {"w": ends["lm_head.weight"].T.contiguous()}},
                               bits=4)["lm_head"]
    return {"token_emb": ends["model.embed_tokens.weight"].clone(), "blocks": blocks,
            "norm": {"scale": torch.ones(d.d_model, dtype=dv3.weights.DTYPE, device=device)},
            "lm_head": head}


class Served(list):
    """A served sequence's tokens (a list, as llm_enrich's samples hold
    them) with `routes`: the expert ids each MoE layer chose at each
    position, as the router kernel logged them while serving ((MoE
    layers, T, top_k), −1 at the last position, which no forward
    reached)."""

    routes: torch.Tensor


def judge(cfg: dict, seed: int, device, samples: list, control: str | None,
          given: list | None) -> tuple[list, list | None]:
    """The reference's logits at the served positions (routed on its own
    scores, or on `given`), the tokens the control judges in the served
    ones' place (None without a control), and, routed on its own, its
    choices at those positions."""
    out = ref.served_logits(cfg, seed, samples, device, routes=given is None, given=given)
    logits, routes = (out, None) if given is not None else out
    judged = None
    if control == "int4_activations":
        lower = ref.served_logits(cfg, seed, samples, device, act_bits=4, given=given)
        judged = [lg[:len(toks) - p].argmax(-1) for lg, (toks, p) in zip(lower, samples)]
    return llm_enrich.served_gaps(logits, samples, judged), routes


def check(cfg: dict, seed: int, device, samples: list, limits: dict,
          control: str | None = None) -> list[dict]:
    """Two numbers, each llm_enrich's `mean_gap` (the mean, over the served
    tokens of the sampled greedy calls, of the gap by which the
    reference's best token beats the served one; control
    "int4_activations": the reference's own token at int4 decode
    activations judged in the served one's place), against the
    reference routed on its own f32 scores (`mean_gap`) and routed on the
    program's logged choices (`mean_gap_routed`). Beside the first, the
    diagnostic `routing_differs`: the share of (token, MoE layer) choices
    at the served positions on which the program and the reference
    differ, and its value a layer."""
    t0 = time.perf_counter()
    own, routes = judge(cfg, seed, device, samples, control, None)
    stats = gaps.summary(own)
    record = {"name": "mean_gap", "value": stats["mean"], "limit": limits["mean_gap"], **stats}
    given = [toks.routes for toks, _ in samples]
    differ = [[(got[p - 1:len(toks) - 1].sort(-1).values.to(want.device)
                != want[:-1]).any(-1) for got, want in zip(toks.routes, chosen)]
              for (toks, p), chosen in zip(samples, routes)]
    record["routing_differs"] = torch.cat([r for seq in differ for r in seq]).float().mean().item()
    record["routing_differs_by_layer"] = [round(torch.cat(rows).float().mean().item(), 4)
                                          for rows in zip(*differ)]
    stats = gaps.summary(judge(cfg, seed, device, samples, control, given)[0])
    routed = {"name": "mean_gap_routed", "value": stats["mean"],
              "limit": limits["mean_gap_routed"], **stats}
    record["seconds"] = routed["seconds"] = time.perf_counter() - t0
    return [record, routed]


class RoutesTap(llm_enrich.GenerateTap):
    """llm_enrich's GenerateTap that also keeps, with each model call, the
    experts the program's router chose at each position: it wraps
    models/deepseek_v3.py's `init_kv_cache` (a log (MoE layers, B, S,
    top_k) int32 made beside each call's cache), `forward` (the position
    of the rows, a host int or the graphed step's device tensor, and the
    count of expert layers reset) and `route` (the log's layer and the
    position handed to the router kernel, which writes the ids there). A
    graphed step captures the kernel with its log; nothing is copied
    while the window runs."""

    def __init__(self):
        from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds

        super().__init__()
        self.ds = ds
        self.originals = {n: getattr(ds, n) for n in ("init_kv_cache", "forward", "route")}
        self.log, self.pos, self.layer = None, 0, 0
        ds.init_kv_cache, ds.forward, ds.route = self._init_cache, self._forward, self._route

    def _init_cache(self, dims, batch, max_len, *args, **kw):
        self.log = torch.zeros((dims.n_layer - dims.first_dense, batch, max_len, dims.top_k),
                               dtype=torch.int32, device=kw.get("device", "cpu"))
        return self.originals["init_kv_cache"](dims, batch, max_len, *args, **kw)

    def _forward(self, params, dims, tokens, cache=None, pos=0):
        self.pos, self.layer = pos, 0
        return self.originals["forward"](params, dims, tokens, cache, pos)

    def _route(self, h, router, dims):
        log = self.log[self.layer] if self.log is not None else None
        self.layer += 1
        return self.originals["route"](h, router, dims, log, self.pos)

    def _generate(self, params, dims, prompt, **kw):
        res = super()._generate(params, dims, prompt, **kw)
        self.current[-1]["routes"], self.log = self.log, None
        return res

    def close(self) -> None:
        super().close()
        for name, fn in self.originals.items():
            setattr(self.ds, name, fn)


class Entry(llm_enrich.Entry):
    """llm_enrich's Entry (its pool, calls, records, timings and samples)
    with this configuration's model, FLOPs and check."""

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
        self.pool = [traffic.conversation(sizes, rng) for sizes in traffic.conversation_sizes(mix)]
        self.greedy = [k % mix["greedy_every"] == 0 for k in range(len(self.pool))]
        self.tap = RoutesTap()
        self.calls: dict[int, list] = {}

    def call_flops(self, index: int, k: int) -> float:
        return sum(dv3.generate_flops(self.ctx.config, r["prompt"].shape[1],
                                      r["timings"]["decode_forwards"])
                   for r in self.calls[index])

    def samples(self, calls) -> list[tuple[Served, int]]:
        """llm_enrich's samples, each sequence with its routing log."""
        recs = [r for c in calls for r in self.calls[c.index] if r["greedy"]]
        out = []
        for (toks, p), r in zip(super().samples(calls), recs):
            served = Served(toks)
            served.routes = r["routes"][:, 0, :len(toks)].long()
            served.routes[:, -1] = -1
            out.append((served, p))
        return out

    def check(self, calls) -> list[dict]:
        samples = self.samples(calls)
        self.release()
        return check(self.ctx.config, self.ctx.seed, self.ctx.device, samples,
                     self.ctx.cell["limits"])
