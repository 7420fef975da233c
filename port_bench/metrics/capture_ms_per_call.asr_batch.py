"""The decode loops' CUDA graph captures a call: the wall of the port's
`step_loop.capture` spans (the eager warm-up step, the capture, the
instantiation and the pool's allocations) over the traced calls."""

from port_bench.lib import spans


def read(run):
    return spans.per_call(spans.traced(run), "step_loop.capture", len(run.traced))
