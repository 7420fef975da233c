"""The W4A8 launches a decode step that split K over a thread-block
cluster and fold it there: the calls of the port's `s8_cluster_launch`
(ops/quant.py; `int4_matmul_s8` and `int4_moe_s8` call it beside each
such launch) the traced window recorded (graph replays counted, and each
capture's eager warm-up step), over the steps of the port's
`step_loop.loop` spans. 3 a Llama layer (q|k|v, out, down; gate|up
holds every group in a block): 96 at Mistral's 32. A port without that
function records nothing, and the metric reads None."""

import importlib

from port_bench.lib import costs, spans

_COUNTER = {"module": "turbo_whisper_workspace_tpu_torch.ops.quant",
            "wrapper": "s8_cluster_launch"}
if hasattr(importlib.import_module(_COUNTER["module"]), _COUNTER["wrapper"]):
    KERNEL = _COUNTER


def cost(*_, **__):
    return 0.0, 0.0, 0.0


def read(run):
    launches = run.costs.get(costs.kernel_key(_COUNTER), (0,))[0]
    steps = sum(s.attrs.get("steps", 0)
                for s in spans.named(spans.traced(run), "step_loop.loop"))
    return launches / steps if launches and steps else None
