"""The transcriber's host time a window: the wall of the port's
`transcriber.transcribe` spans less their `transcriber.encode`,
`transcriber.detect` and `transcriber.decode` children (planning,
staging, post-processing and merging), over the traced calls' windows."""

from port_bench.lib import spans


def read(run):
    return spans.host_ms_per_window(spans.traced(run))
