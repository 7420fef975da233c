"""`int4_s8_launches_per_step.llm`: the W4A8 kernel's recorded launches
over the decode steps of the port's loop spans, on a hand-built record
and on a traced CPU run of the enrichment cell with the Llama's sibling
projections fused (4 a layer) and apart (7 a layer)."""

import json
from types import SimpleNamespace

import pytest

from port_bench.lib import bench, costs, spans, spec
from port_bench.tests import tiny

METRIC = "int4_s8_launches_per_step.llm"
KEY = costs.kernel_key(spec.metric("int4_matmul_s8_roofline").KERNEL)


def loop(id, steps):
    return SimpleNamespace(id=id, name="step_loop.loop", start_ns=id, end_ns=id + 1,
                           parent=None, request=id, attrs={"steps": steps})


def test_launches_over_the_loops_steps(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 199), loop(5, 255), loop(9, 255)])
    run = SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)),
                          costs={KEY: [128 * (199 + 255 + 255 + 3), 0.0, 0.0, 0.0]})
    # three captures: each one's eager warm-up step launches too
    assert spec.metric(METRIC).read(run) == pytest.approx(128 * (1 + 3 / 709))


def test_nothing_to_read_reads_none(monkeypatch):
    """Untraced, no launch recorded, or a port without spans: None."""
    read = spec.metric(METRIC).read
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 10)])
    assert read(SimpleNamespace(trace=None, costs={})) is None
    assert read(SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)), costs={})) is None
    monkeypatch.setattr(spans, "records", lambda: [])
    assert read(SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)),
                                costs={KEY: [70, 0.0, 0.0, 0.0]})) is None


@pytest.mark.parametrize("fused", [False, True])
def test_a_traced_cpu_run_reads_the_launches_a_step(tmp_path, capsys, monkeypatch, fused):
    """The CPU runs each step eagerly: every step makes exactly a layer's
    launches times the layers, 4 with the siblings fused as TorchLlama
    fuses them, 7 in a port that joins nothing (as the parent's)."""
    from turbo_whisper_workspace_tpu_torch.models import llama

    if not fused:
        monkeypatch.setattr(llama, "fuse_siblings", lambda params: params)
    root = tiny.make_root(str(tmp_path))
    rc = bench.run_cell(root, "mistral7b-enrich", 2**31 + 7, 0.0, True, 0.0, device="cpu",
                        data_dir=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    layers = tiny.LLAMA["num_hidden_layers"]
    assert out["metrics"][METRIC] == {"value": (4 if fused else 7) * layers,
                                      "unit": "launches"}
