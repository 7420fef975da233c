"""A model call's prefill (`generate_tokens`' prefill_s, ending in a
device sync), the mean over the window's calls."""


def read(run):
    t = run.entry.timings("prefill_s")
    return 1e3 * sum(t) / len(t) if t else None
