"""The 90th percentile of the requests' latencies, send to return."""


def read(run):
    return run.latency_ms(90)
