"""`int4_s8_cluster_launches_per_step.llm`: the W4A8 launches that split K
over a thread-block cluster, recorded through the port's
`s8_cluster_launch`, over the decode steps of the port's loop spans; a
port without that function leaves the metric nothing to wrap or read."""

from types import SimpleNamespace

import pytest

from port_bench.lib import costs, spans, spec

METRIC = "int4_s8_cluster_launches_per_step.llm"


def loop(id, steps):
    return SimpleNamespace(id=id, name="step_loop.loop", start_ns=id, end_ns=id + 1,
                           parent=None, request=id, attrs={"steps": steps})


def test_the_port_counts_its_cluster_launches_through_one_function():
    from turbo_whisper_workspace_tpu_torch.ops import quant

    module = spec.metric(METRIC)
    assert module.KERNEL == {"module": quant.__name__, "wrapper": "s8_cluster_launch"}
    assert callable(quant.s8_cluster_launch)
    assert module.cost("int4_matmul_s8") == (0.0, 0.0, 0.0)


def test_cluster_launches_over_the_loops_steps(monkeypatch):
    module = spec.metric(METRIC)
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 199), loop(5, 255), loop(9, 255)])
    run = SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)),
                          costs={costs.kernel_key(module.KERNEL):
                                 [96 * (199 + 255 + 255 + 3), 0.0, 0.0, 0.0]})
    # three captures: each one's eager warm-up step launches too
    assert module.read(run) == pytest.approx(96 * (1 + 3 / 709))


def test_nothing_to_read_reads_none(monkeypatch):
    read = spec.metric(METRIC).read
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 10)])
    assert read(SimpleNamespace(trace=None, costs={})) is None
    assert read(SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)), costs={})) is None


def test_a_port_without_the_counter_gives_the_harness_nothing_to_wrap(monkeypatch):
    """The parent of the cluster fold has no `s8_cluster_launch`: the
    metric names no KERNEL there, so a traced run wraps nothing for it,
    and it reads None."""
    from turbo_whisper_workspace_tpu_torch.ops import quant

    monkeypatch.delattr(quant, "s8_cluster_launch")
    module = spec.metric(METRIC)
    assert not hasattr(module, "KERNEL")
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 10)])
    assert module.read(SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)),
                                       costs={})) is None
