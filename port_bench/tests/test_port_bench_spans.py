"""The readers of the port's own spans (`lib/spans.py`, the metrics that
read them): self time over nested and overlapping children, grouping by
request, each span metric on a hand-built record, a traced run of each
cell on the CPU in which every span metric reads a number, and no span's
shadow on the device's timeline counted as device work."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench.lib import bench, spans, spec
from port_bench.lib import trace as bench_trace
from port_bench.tests import tiny

MS = 1_000_000
METRICS = {m["name"]: m for m in spec.Spec(tiny.ROOT).data["per_layer"]
           if m["source"] == "program_span" and m["name"].split(".")[0] in (
               "host_ms_per_window", "capture_ms_per_call", "loop_ms_per_step",
               "load_ms_per_request", "host_ms_per_call")}


def rec(id, name, start, end, parent=None, request=None, **attrs):
    """A span as the port records it; times in ms."""
    return SimpleNamespace(id=id, name=name, start_ns=start * MS, end_ns=end * MS,
                           parent=parent, request=request or id, attrs=attrs)


def test_the_metrics_are_the_eight_span_metrics():
    assert len(METRICS) == 8
    assert all(len(m["workloads"]) == 1 for m in METRICS.values())


def test_self_time_counts_overlapping_children_once_and_only_the_listed_ones():
    parent = rec(1, "p", 0, 100)
    record = [parent,
              rec(2, "a", 10, 30, parent=1, request=1),
              rec(3, "a", 20, 40, parent=1, request=1),      # overlaps the first
              rec(4, "b", 50, 60, parent=1, request=1),      # not listed
              rec(5, "a", 90, 120, parent=1, request=1),     # runs past its parent
              rec(6, "a", 12, 14, parent=2, request=1)]      # a grandchild
    assert spans.self_ns(parent, record, ("a",)) == (100 - 30 - 10) * MS
    assert spans.self_ns(parent, record, ("a", "b")) == (100 - 30 - 10 - 10) * MS
    assert spans.self_ms(record, "p", ()) == 100.0
    assert spans.covered_ns([(0, 5), (1, 2), (3, 9)], 2, 8) == 6


def test_spans_group_by_request():
    record = [rec(2, "x", 0, 1, parent=1, request=1), rec(1, "call", 0, 2),
              rec(4, "x", 3, 4, parent=3, request=3), rec(3, "call", 3, 5)]
    groups = spans.by_request(record)
    assert sorted(groups) == [1, 3]
    assert [s.id for s in groups[1]] == [2, 1] and [s.id for s in groups[3]] == [4, 3]


def run_of(record, calls, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: record)
    return SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 10_000 * MS)),
                           traced=[object()] * calls)


def batch_call(base, windows, capture_ms):
    """One transcribe call at `base` ms: encode 10, detect 5, two decodes
    of 100 (each with a capture and a loop of 200 steps), plan, post and
    merge around them."""
    c = base
    return [rec(c + 1, "transcriber.transcribe", c, c + 300, windows=windows),
            rec(c + 2, "transcriber.plan", c, c + 4, parent=c + 1, request=c + 1),
            rec(c + 3, "transcriber.encode", c + 4, c + 14, parent=c + 1, request=c + 1),
            rec(c + 4, "transcriber.detect", c + 14, c + 19, parent=c + 1, request=c + 1),
            rec(c + 5, "transcriber.decode", c + 20, c + 120, parent=c + 1, request=c + 1),
            rec(c + 6, "step_loop.capture", c + 25, c + 25 + capture_ms, parent=c + 5,
                request=c + 1),
            rec(c + 7, "step_loop.loop", c + 60, c + 110, parent=c + 5, request=c + 1,
                steps=200),
            rec(c + 8, "transcriber.postprocess", c + 120, c + 130, parent=c + 1,
                request=c + 1),
            rec(c + 9, "transcriber.decode", c + 130, c + 230, parent=c + 1, request=c + 1),
            rec(c + 10, "step_loop.loop", c + 140, c + 190, parent=c + 9, request=c + 1,
                steps=200),
            rec(c + 11, "transcriber.merge", c + 290, c + 300, parent=c + 1, request=c + 1)]


def test_the_batch_metrics_on_a_hand_built_record(monkeypatch):
    run = run_of(batch_call(0, 8, 30) + batch_call(1000, 8, 20), 2, monkeypatch)
    read = {n: spec.metric(n).read(run) for n in METRICS if n.endswith("asr_batch")}
    # (300 - 10 - 5 - 200) ms of each call's own over its 8 windows
    assert read["host_ms_per_window.asr_batch"] == pytest.approx(85 / 8)
    assert read["capture_ms_per_call.asr_batch"] == pytest.approx(25)
    assert read["loop_ms_per_step.asr_batch"] == pytest.approx(200 / 800)


def test_the_request_metrics_on_a_hand_built_record(monkeypatch):
    record = []
    for i, base in enumerate((0, 1000, 2000)):
        call = batch_call(base + 10, 1 + i, 40)
        req = rec(base + 1, "pipeline.transcribe", base, base + 400)
        for s in call:
            s.request = req.id
        call[0].parent = req.id
        record += [rec(base + 2, "audio.read", base, base + 2 + i, parent=req.id,
                       request=req.id), *call, req]
    run = run_of(record, 3, monkeypatch)
    read = {n: spec.metric(n).read(run) for n in METRICS if n.endswith("asr_request")}
    assert read["host_ms_per_window.asr_request"] == pytest.approx(3 * 85 / 6)
    assert read["capture_ms_per_call.asr_request"] == pytest.approx(40)
    assert read["load_ms_per_request.asr_request"] == pytest.approx(3)


def test_the_llm_metrics_on_a_hand_built_record(monkeypatch):
    record = []
    for i in range(3):                  # names, summary, topics
        b = 1000 * i
        record += [rec(b + 3, "llm.prefill", b + 10, b + 80, parent=b + 2, request=b + 1),
                   rec(b + 4, "step_loop.capture", b + 80, b + 120, parent=b + 2,
                       request=b + 1),
                   rec(b + 2, "llm.generate", b + 5, b + 900, parent=b + 1, request=b + 1),
                   rec(b + 1, "llm.stage", b, b + 920)]
    run = run_of(record, 1, monkeypatch)
    assert spec.metric("capture_ms_per_call.llm").read(run) == pytest.approx(120)
    assert spec.metric("host_ms_per_call.llm").read(run) == pytest.approx(3 * 25)


def test_no_tracer_reads_nothing(monkeypatch):
    """The parent commit's port has no `profiling.spans`: every metric
    reads None and none raises."""
    from turbo_whisper_workspace_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    run = SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 10**18)), traced=[object()])
    assert spans.records() == []
    assert all(spec.metric(n).read(run) is None for n in METRICS)
    assert all(spec.metric(n).read(SimpleNamespace(trace=None, traced=[])) is None
               for n in METRICS)


@pytest.mark.parametrize("cell", ["turbo-batch-greedy", "turbo-requests", "mistral7b-enrich"])
def test_a_traced_cpu_run_reads_every_span_metric_of_its_cell(tmp_path, capsys, cell):
    root = tiny.make_root(str(tmp_path))
    rc = bench.run_cell(root, cell, 2**31 + 11, 0.0, True, 0.0, device="cpu", data_dir=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    mine = [n for n, m in METRICS.items() if m["workloads"] == [cell]]
    assert mine and all(n in out["metrics"] for n in mine), out["metrics"]
    for n in mine:
        value = out["metrics"][n]["value"]
        # the CPU's loops run eagerly: no capture
        assert value == 0.0 if n.startswith("capture_ms") else value > 0, (n, value)


def test_no_span_shadow_counts_as_device_work():
    """A card's trace puts a shadow of each host annotation on the
    device's timeline; the port's spans are annotations with fixed
    names, so `Trace.from_profiler` drops their shadows as it drops the
    harness's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.pipeline import transcriber
    from turbo_whisper_workspace_tpu_torch.utils import profiling

    dims = wm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
    tr = transcriber.load_transcriber(
        wm.init_params(dims, torch.Generator().manual_seed(0)),
        TranscriptionConfig(batch_size=2, max_decode_len=3), device="cpu")
    audio = (0.3 * np.sin(2 * np.pi * 180 * np.arange(6 * 16000) / 16000)).astype(np.float32)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(bench_trace.WINDOW):
            tr.transcribe([audio])
    record = profiling.spans()
    profiling.clear_spans()
    events = list(prof.profiler.kineto_results.events())
    assert record and {s.name for s in record} <= {e.name() for e in events}

    class Shadow:
        """A span's shadow on the device's timeline, as a card's trace has it."""

        def __init__(self, s, name=None):
            self.s, self._name = s, name or s.name

        def name(self):
            return self._name

        def start_ns(self):
            return self.s.start_ns

        def duration_ns(self):
            return self.s.end_ns - self.s.start_ns

        def device_type(self):
            return DeviceType.CUDA

    kernel = Shadow(record[0], "a_kernel")
    results = SimpleNamespace(events=lambda: events + [Shadow(s) for s in record] + [kernel])
    t = bench_trace.Trace.from_profiler(SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=results)))
    assert [op[0] for op in t.device_ops] == ["a_kernel"]
    assert t.busy_s == pytest.approx(kernel.duration_ns() / 1e9)
