"""`mla_cluster16_launches_per_step.moe`: the latent-attention launches
whose cluster takes 16 blocks, recorded through the port's
`mla_cluster_launch`, over the decode steps of the port's loop spans; a
port without that function leaves the metric nothing to wrap or read."""

from types import SimpleNamespace

import pytest

from port_bench.lib import costs, spans, spec

METRIC = "mla_cluster16_launches_per_step.moe"


def loop(id, steps):
    return SimpleNamespace(id=id, name="step_loop.loop", start_ns=id, end_ns=id + 1,
                           parent=None, request=id, attrs={"steps": steps})


def test_the_port_counts_its_wide_launches_through_one_function():
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops

    module = spec.metric(METRIC)
    assert module.KERNEL == {"module": mla_ops.__name__, "wrapper": "mla_cluster_launch"}
    assert callable(mla_ops.mla_cluster_launch)
    assert module.cost(16) == (0.0, 0.0, 0.0)


def test_wide_launches_over_the_loops_steps(monkeypatch):
    module = spec.metric(METRIC)
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 199), loop(5, 255)])
    run = SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)),
                          costs={costs.kernel_key(module.KERNEL): [27 * (199 + 255 + 2), 0.0,
                                                                   0.0, 0.0]})
    # two captures: each one's eager warm-up step launches too
    assert module.read(run) == pytest.approx(27 * (1 + 2 / 454))


def test_a_port_without_the_counter_gives_the_harness_nothing_to_wrap(monkeypatch):
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops

    monkeypatch.delattr(mla_ops, "mla_cluster_launch")
    module = spec.metric(METRIC)
    assert not hasattr(module, "KERNEL")
    monkeypatch.setattr(spans, "records", lambda: [loop(1, 10)])
    assert module.read(SimpleNamespace(trace=SimpleNamespace(window_ns=(0, 100)),
                                       costs={})) is None
