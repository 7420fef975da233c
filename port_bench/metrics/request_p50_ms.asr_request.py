"""The median request latency, beside the 90th percentile."""


def read(run):
    return run.latency_ms(50)
