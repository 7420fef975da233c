"""The transcriber's host time a window, as `host_ms_per_window.asr_batch`,
over the traced requests' windows."""

from port_bench.lib import spans


def read(run):
    return spans.host_ms_per_window(spans.traced(run))
