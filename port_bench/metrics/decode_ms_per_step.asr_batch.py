"""A greedy decode's device time (CUDA events around each
`greedy_decode_features` call: prefill, capture and steps) over the
steps it ran."""

from port_bench.lib import asr


def read(run):
    return asr.decode_ms_per_step(run.entry.tap)
