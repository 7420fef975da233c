"""The card's peaks, the least time a launch could take, the forward
FLOPs of a model from its configuration, and a recorder that sums a
kernel's costs over the launches a run makes, graph replays included.

A kernel's operations and bytes of one launch, from its shapes, live in
its roofline metric's file (`metrics/<kernel>_roofline.py`: `KERNEL`
names the port's wrapper, `cost(*args)` counts a launch). Each input
byte is counted once and each output byte once, whatever a kernel reads
again; work that depends on the data (keys past a valid length, padded
columns) is counted as these inputs need it. The peaks are the NVIDIA
H100 SXM data sheet's (dense, at its 700 W limit): a frozen copy, so the
program's own table may change without moving the yardstick.
"""

from __future__ import annotations

import functools
import importlib
from collections import defaultdict

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_S = 3.35e12
# the port's decode-loop graph: a launch made while one captures runs at each replay
STEP_GRAPH = ("turbo_whisper_workspace_tpu_torch.utils.step_loop", "StepGraph")


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES_S)


# ---------------------------------------------------------------------------
# models: forward FLOPs of the work a call needs (padding rows, repeated
# logits and warm-up steps not counted)


def whisper_encoder_flops(cfg: dict) -> float:
    """One 30 s window through the convolutions and the encoder."""
    d, ff, t = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["max_source_positions"]
    frames = 2 * t
    conv = 2.0 * cfg["num_mel_bins"] * d * 3 * frames + 2.0 * d * d * 3 * t
    layer = 2.0 * t * (4 * d * d + 2 * d * ff) + 4.0 * t * t * d
    return conv + cfg["encoder_layers"] * layer


def whisper_cross_kv_flops(cfg: dict) -> float:
    """One window's cross-attention K and V over every decoder layer."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    return cfg["decoder_layers"] * 2 * 2.0 * t * d * d


def whisper_token_flops(cfg: dict, pos: int) -> float:
    """The decoder body for one token at position `pos` (no logits)."""
    d, ff, t = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["max_source_positions"]
    layer = 2.0 * (6 * d * d + 2 * d * ff) + 4.0 * (pos + 1) * d + 4.0 * t * d
    return cfg["decoder_layers"] * layer


def whisper_decode_flops(cfg: dict, prompt: int, forwards: int) -> float:
    """One row of a decode: the prompt's prefill, `forwards` steps, and
    the logits it reads (the first sample's, the no-speech row's, each
    step's)."""
    body = sum(whisper_token_flops(cfg, p) for p in range(prompt + forwards))
    return body + (forwards + 2) * 2.0 * cfg["d_model"] * cfg["vocab_size"]


def whisper_detect_flops(cfg: dict, n_languages: int) -> float:
    """One row of language detection: <|sot|> and its language logits."""
    return whisper_token_flops(cfg, 0) + 2.0 * cfg["d_model"] * n_languages


def llama_token_flops(cfg: dict, pos: int) -> float:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    kv = cfg["num_key_value_heads"] * (d // cfg["num_attention_heads"])
    proj = 2.0 * (2 * d * d + 2 * d * kv + 3 * d * ff)
    return cfg["num_hidden_layers"] * (proj + 4.0 * (pos + 1) * d)


def llama_generate_flops(cfg: dict, prompt: int, forwards: int) -> float:
    """A prefill of `prompt` tokens, then `forwards` decode steps; logits
    of the last prompt position and of each step."""
    body = sum(llama_token_flops(cfg, p) for p in range(prompt + forwards))
    return body + (forwards + 1) * 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


# ---------------------------------------------------------------------------
# the recorder


def kernel_key(kernel: dict) -> str:
    """The name a roofline metric's kernel is recorded under."""
    return f"{kernel['module']}.{kernel['wrapper']}"


class CostRecorder:
    """Sums (launches, flops, bytes, bound seconds) per kernel over the
    launches made while it is on. It wraps the kernels' wrappers on their
    modules (`wrap_kernel`), and the port's StepGraph: a launch made while
    a graph captures is charged to that graph and counted again at each
    of its replays, as the kernels run then."""

    def __init__(self):
        self.on = False
        self.totals = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        self._capturing: list | None = None
        self._undo: list = []

    def add(self, name: str, cost: tuple) -> None:
        if not self.on:
            return
        if self._capturing is not None and torch.cuda.is_current_stream_capturing():
            self._capturing.append((name, cost))
            return
        t = self.totals[name]
        t[0] += 1
        for i, x in enumerate(cost):
            t[i + 1] += x

    def _patch(self, owner, attr: str, new) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def wrap_kernel(self, kernel: dict, cost) -> None:
        """kernel: {"module", "wrapper"} (a roofline metric's KERNEL);
        cost(*args, **kwargs) → (flops, bytes, bound seconds) of a launch."""
        module = importlib.import_module(kernel["module"])
        fn, key = getattr(module, kernel["wrapper"]), kernel_key(kernel)

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.add(key, cost(*args, **kwargs))
            return out

        self._patch(module, kernel["wrapper"], counted)

    def wrap_step_graph(self, step_graph_cls=None) -> None:
        if step_graph_cls is None:
            module, name = STEP_GRAPH
            step_graph_cls = getattr(importlib.import_module(module), name)
        init, replay, rec = step_graph_cls.__init__, step_graph_cls.replay, self

        def traced_init(graph, *args, **kwargs):
            outer, rec._capturing = rec._capturing, []
            try:
                init(graph, *args, **kwargs)
                graph._port_bench_costs = rec._capturing
            finally:
                rec._capturing = outer

        def traced_replay(graph):
            replay(graph)
            for name, cost in getattr(graph, "_port_bench_costs", ()):
                rec.add(name, cost)

        self._patch(step_graph_cls, "__init__", traced_init)
        self._patch(step_graph_cls, "replay", traced_replay)

    def restore(self) -> None:
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo.clear()
