"""Profiling helpers: the JAX package's StageTimer, and the port's
`trace` (turbo_whisper_workspace_tpu_torch/utils/profiling.py) writing a
Chrome trace that carries the program's spans. The port's tracer itself
is tested in tests/test_torch_tracing.py."""

import json
import time

import pytest
import torch

from turbo_whisper_workspace_tpu.utils import profiling as jprof
from turbo_whisper_workspace_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("cls", [jprof.StageTimer], ids=["jax"])
def test_stage_timer(cls):
    t = cls()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("b"):
        pass
    times = t.finish()
    assert sorted(times) == ["a", "b", "total"]
    assert times["a"] >= 0.02 and times["total"] >= times["a"] + times["b"]
    assert t.realtime_factor(10.0) == pytest.approx(times["total"] / 10.0)
    assert t.realtime_factor(0.0) == 0.0


def test_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)) as prof:
        with tprof.span("transcriber.transcribe", files=1):
            torch.randn(32, 32) @ torch.randn(32, 32)
    assert prof is not None
    data = json.loads((log_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in data["traceEvents"]}
    assert any("mm" in n for n in names)
    assert "transcriber.transcribe" in names
    assert [s.name for s in tprof.spans()] == ["transcriber.transcribe"]
