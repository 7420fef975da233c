"""The experts' share of the prefill, in %: the wall of the port's
`moe.experts` spans (each expert layer's one-matmul-per-expert loop over
the prompt's rows, after the routing's host read) over the wall of its
`llm.prefill` spans, in the traced window."""

from port_bench.lib import spans


def read(run):
    traced = spans.traced(run)
    prefill = spans.wall_ms(traced, "llm.prefill")
    experts = spans.wall_ms(traced, "moe.experts")
    return 100.0 * experts / prefill if prefill and experts else None
