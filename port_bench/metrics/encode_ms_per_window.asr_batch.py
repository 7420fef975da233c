"""Encoding's device time a window: CUDA events around each
`Transcriber._encode_windows` call (the mel frontend, the encoder, the
int8 cross-K/V) over the windows of its batch."""

from port_bench.lib import asr


def read(run):
    return None if run.entry.inst is None else asr.encode_ms_per_window(run.entry.inst)
