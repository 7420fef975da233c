"""The latent-attention launches a decode step whose cluster takes 16
blocks (the non-portable size): the calls of the port's
`mla_cluster_launch` (ops/mla_ops.py; `mla_attention` calls it beside
each such launch) the traced window recorded (graph replays counted, and
each capture's eager warm-up step), over the steps of the port's
`step_loop.loop` spans. 1 a layer where every launch takes 16 ranks: 27
at Moonlight's 27. A port without that function records nothing, and the
metric reads None."""

import importlib

from port_bench.lib import costs, spans

_COUNTER = {"module": "turbo_whisper_workspace_tpu_torch.ops.mla_ops",
            "wrapper": "mla_cluster_launch"}
if hasattr(importlib.import_module(_COUNTER["module"]), _COUNTER["wrapper"]):
    KERNEL = _COUNTER


def cost(*_, **__):
    return 0.0, 0.0, 0.0


def read(run):
    launches = run.costs.get(costs.kernel_key(_COUNTER), (0,))[0]
    steps = sum(s.attrs.get("steps", 0)
                for s in spans.named(spans.traced(run), "step_loop.loop"))
    return launches / steps if launches and steps else None
