"""The generation loop's seconds (`generate_tokens`' decode_s: the
capture and the graphed steps, ending in a device sync) over its decode
forwards, across the window's model calls."""


def read(run):
    steps = sum(run.entry.timings("decode_forwards"))
    return 1e3 * sum(run.entry.timings("decode_s")) / steps if steps else None
