"""The experts' W4A8 launches a decode step: the `int4_moe_s8` launches
the traced window recorded (graph replays counted, and each capture's
eager warm-up step) over the steps of the port's `step_loop.loop` spans.
2 an expert layer (gate|up, down): 52 at Moonlight's 26."""

from port_bench.lib import costs, spans, spec


def read(run):
    kernel = spec.metric("int4_moe_s8_roofline").KERNEL
    launches = run.costs.get(costs.kernel_key(kernel), (0,))[0]
    steps = sum(s.attrs.get("steps", 0)
                for s in spans.named(spans.traced(run), "step_loop.loop"))
    return launches / steps if launches and steps else None
