"""A greedy loop's step after its capture: the wall of the port's
`step_loop.loop` spans (graph replays and stop-flag reads; no prefill,
no capture) over the steps they ran."""

from port_bench.lib import spans


def read(run):
    loops = spans.named(spans.traced(run), "step_loop.loop")
    steps = sum(s.attrs.get("steps", 0) for s in loops)
    return spans.wall_ms(loops, "step_loop.loop") / steps if steps else None
