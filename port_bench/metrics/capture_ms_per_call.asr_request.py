"""The decode loops' CUDA graph captures a request: the wall of the port's
`step_loop.capture` spans over the traced requests."""

from port_bench.lib import spans


def read(run):
    return spans.per_call(spans.traced(run), "step_loop.capture", len(run.traced))
