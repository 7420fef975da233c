"""Operation and byte counts against worked examples; the cost recorder's
graph accounting; the trace arithmetic on synthetic events."""

import sys
import types

import pytest
import torch

from port_bench.lib import costs, spec, trace

TURBO = spec.load_json(f"{spec.BENCH_DIR}/configs/whisper-large-v3-turbo.json")
ROOFLINES = {m["name"]: spec.metric(m["name"]) for m in spec.Spec(
    __import__("os").path.dirname(spec.BENCH_DIR)).data["per_layer"]
    if m["name"].endswith("_roofline")}
MISTRAL = spec.load_json(f"{spec.BENCH_DIR}/configs/mistral-7b-v0.3-q4.json")


def t(*shape):
    return torch.empty(shape, device="meta")


def test_flash_attention_counts():
    # B=1, H=1, T=2, D=4: QK^T and PV are 2·T·T·D each; q, k, v, out 8 bytes a row
    flops, nbytes, bound = ROOFLINES["flash_attention_roofline"].cost(t(1, 1, 2, 4), t(1, 1, 2, 4), t(1, 1, 2, 4))
    assert flops == 64 and nbytes == 64
    # the encoder at batch 32: 4·32·20·1500²·64 = 368.64 GFLOP, bound by operations
    flops, nbytes, bound = ROOFLINES["flash_attention_roofline"].cost(*(t(32, 20, 1500, 64),) * 3)
    assert flops == 368.64e9
    assert nbytes == 4 * 32 * 20 * 1500 * 64 * 2
    assert bound == pytest.approx(368.64e9 / 989e12)


def test_cross_attention_int8_counts_the_keys_it_needs():
    q = t(32, 20, 1, 64)
    kq, vq = t(32, 20, 64, 1536), t(32, 1536, 1280)
    flops, nbytes, bound = ROOFLINES["cross_attention_int8_roofline"].cost(q, kq, vq, t(32, 20), t(32, 20),
                                                      seq_len=1500)
    kv = 2 * 32 * 20 * 1500 * 64                    # int8 K and V over 1500 keys, not 1536
    assert nbytes == kv + 2 * 4 * 32 * 20 + 2 * 2 * 32 * 20 * 64
    assert bound == pytest.approx(nbytes / 3.35e12)


def test_int4_matmul_s8_counts_at_a_decode_row():
    # M=1, K=4096, N=14336, 32 groups: nibbles K/2·N, f32 scales, int8 x and its scales, bf16 out
    _, nbytes, bound = ROOFLINES["int4_matmul_s8_roofline"].cost(t(1, 4096), t(1, 32), t(2048, 14336), t(32, 14336))
    assert nbytes == 2048 * 14336 + 4 * 32 * 14336 + 4096 + 4 * 32 + 2 * 14336
    assert bound == pytest.approx(nbytes / 3.35e12)


def test_int4_matmul_is_bound_by_operations_at_a_prefill():
    flops, nbytes, bound = ROOFLINES["int4_matmul_roofline"].cost(t(1500, 4096), t(2048, 14336), t(32, 14336))
    assert flops == 2 * 1500 * 4096 * 14336
    assert nbytes == 2 * 1500 * 4096 + 2048 * 14336 + 4 * 32 * 14336 + 2 * 1500 * 14336
    assert bound == pytest.approx(flops / 989e12)


def test_whisper_model_flops():
    d, f = 1280, 5120
    layer = 2 * 1500 * (4 * d * d + 2 * d * f) + 4 * 1500 * 1500 * d
    conv = 2 * 128 * d * 3 * 3000 + 2 * d * d * 3 * 1500
    assert costs.whisper_encoder_flops(TURBO) == conv + 32 * layer
    assert costs.whisper_cross_kv_flops(TURBO) == 4 * 2 * 2 * 1500 * d * d
    step = 4 * (2 * (6 * d * d + 2 * d * f) + 4 * 11 * d + 4 * 1500 * d)
    assert costs.whisper_token_flops(TURBO, 10) == step
    # a decode of prompt 3 and 2 steps: 5 token bodies and 4 rows of logits
    body = sum(costs.whisper_token_flops(TURBO, p) for p in range(5))
    assert costs.whisper_decode_flops(TURBO, 3, 2) == body + 4 * 2 * d * 51866


def test_llama_model_flops():
    d, kv, f = 4096, 1024, 14336
    proj = 2 * (2 * d * d + 2 * d * kv + 3 * d * f)
    assert costs.llama_token_flops(MISTRAL, 0) == 32 * (proj + 4 * d)
    assert costs.llama_generate_flops(MISTRAL, 2, 1) == (
        costs.llama_token_flops(MISTRAL, 0) + costs.llama_token_flops(MISTRAL, 1)
        + costs.llama_token_flops(MISTRAL, 2) + 2 * 2 * d * 32768)


class FakeGraph:
    """A StepGraph's shape: __init__ runs the step (a capture), replay runs nothing."""

    def __init__(self, step, state=None, generator=None):
        self.capturing = True
        step()
        self.capturing = False

    def replay(self):
        pass


def test_every_roofline_names_a_wrapper_of_the_port_and_counts_a_launch():
    import importlib

    assert len(ROOFLINES) == 4
    for name, m in ROOFLINES.items():
        assert name == f"{m.KERNEL['wrapper']}_roofline"
        assert callable(getattr(importlib.import_module(m.KERNEL["module"]), m.KERNEL["wrapper"]))
        assert m.KERNEL["trace"].startswith(m.KERNEL["wrapper"])


def test_recorder_counts_a_capture_at_every_replay(monkeypatch):
    module = types.ModuleType("port_bench_fake_kernels")
    module.flash_attention = lambda q, k, v: q
    monkeypatch.setitem(sys.modules, module.__name__, module)
    kernel = {"module": module.__name__, "wrapper": "flash_attention", "trace": "fa"}
    key = costs.kernel_key(kernel)
    rec = costs.CostRecorder()
    rec.wrap_kernel(kernel, ROOFLINES["flash_attention_roofline"].cost)
    graph_cls = type("G", (FakeGraph,), {})
    rec.wrap_step_graph(graph_cls)
    q = t(1, 1, 2, 4)
    state = {"capturing": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state["capturing"])
    rec.on = True
    module.flash_attention(q, q, q)                       # eager: counted once

    def step():
        state["capturing"] = True
        module.flash_attention(q, q, q)
        state["capturing"] = False

    g = graph_cls(step)
    assert rec.totals[key][0] == 1                        # the capture runs nothing
    for _ in range(3):
        g.replay()
    launches, flops, nbytes, _ = rec.totals[key]
    assert (launches, flops, nbytes) == (4, 4 * 64, 4 * 64)
    rec.on = False
    g.replay()
    assert rec.totals[key][0] == 4
    rec.restore()
    assert module.flash_attention(q, q, q) is q and graph_cls.replay is FakeGraph.replay


def test_trace_busy_idle_and_breakdown():
    device = [("k_a", 10, 20), ("k_b", 15, 30), ("k_a", 50, 60), ("memcpy", 95, 120)]
    host = [("port_bench.call 0", 0, 100), ("aten::mm", 5, 12), ("cudaStreamSynchronize", 30, 49)]
    tr = trace.Trace(device, host, (0, 100))
    assert tr.busy_intervals == [[10, 30], [50, 60], [95, 100]]
    assert tr.busy_s == pytest.approx(35e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.idle_share() == pytest.approx(0.65)
    assert tr.kernel_time("k_a") == (pytest.approx(20e-9), 2)
    assert tr.gaps() == [(0, 10), (30, 50), (60, 95)]
    out = tr.breakdown()
    assert out["device_ops"][0][0] == "k_a"
    # each gap named by the innermost host event open at its middle
    assert dict(out["idle_gaps"]) == pytest.approx({
        "aten::mm": 10e-9, "cudaStreamSynchronize": 20e-9, "port_bench.call 0": 35e-9})
