"""Port profiling helpers (turbo_whisper_workspace_tpu_torch/utils/
profiling.py): StageTimer as the JAX package's, KernelRoofline's
arithmetic with the H100 data-sheet peaks, speed_of_light on the CPU,
and trace writing a Chrome trace."""

import json
import time

import pytest
import torch

from turbo_whisper_workspace_tpu.utils import profiling as jprof
from turbo_whisper_workspace_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("cls", [tprof.StageTimer, jprof.StageTimer], ids=["torch", "jax"])
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


def test_peaks_are_the_h100_data_sheet():
    assert (tprof.PEAK_BF16_FLOPS, tprof.PEAK_INT8_OPS, tprof.PEAK_HBM_BYTES_S) == \
        (989e12, 1979e12, 3.35e12)


@pytest.mark.parametrize("flops, nbytes, bound", [
    (989e9, 1e6, "flops"),        # 1 ms of bf16 work, a trace of bytes
    (1e6, 3.35e9, "bytes"),       # 1 ms of HBM traffic
])
def test_kernel_roofline_arithmetic(flops, nbytes, bound):
    r = tprof.KernelRoofline("k", seconds=2e-3, flops=flops, bytes_accessed=nbytes)
    assert r.sol_time == pytest.approx(1e-3)
    assert r.sol_fraction == pytest.approx(0.5)
    assert r.achieved_flops == pytest.approx(flops / 2e-3)
    assert r.achieved_bytes_s == pytest.approx(nbytes / 2e-3)
    rep = r.report()
    assert rep.startswith("k: 2.00 ms") and rep.endswith("SoL 50%")
    assert ("(50% peak)" in rep.split("|")[1]) == (bound == "flops")
    # the JAX class with the same peaks computes the same numbers
    j = jprof.KernelRoofline("k", seconds=2e-3, flops=flops, bytes_accessed=nbytes,
                             peak_flops=tprof.PEAK_BF16_FLOPS,
                             peak_bytes_s=tprof.PEAK_HBM_BYTES_S)
    assert (j.sol_time, j.sol_fraction, j.report()) == (r.sol_time, r.sol_fraction, rep)
    assert tprof.KernelRoofline("z", seconds=0.0).sol_fraction == 0.0


def test_speed_of_light_on_cpu():
    a = torch.randn(64, 64)
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": x @ x}

    r = tprof.speed_of_light("mm", fn, a, flops=2 * 64**3, bytes_accessed=3 * 64 * 64 * 4,
                             iters=3)
    assert len(calls) == 4                      # one warm-up, three timed
    assert r.name == "mm" and r.seconds > 0 and r.flops == 2 * 64**3


def test_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert prof is not None
    data = json.loads((log_dir / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in data["traceEvents"])
