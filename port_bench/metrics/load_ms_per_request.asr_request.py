"""A request's file read and decode: the wall of the port's `audio.read`
spans of each traced request (the spans of one `pipeline.transcribe`),
the mean over the requests."""

from port_bench.lib import spans


def read(run):
    requests = [group for group in spans.by_request(spans.traced(run)).values()
                if spans.named(group, "pipeline.transcribe")]
    if not requests:
        return None
    return sum(spans.wall_ms(group, "audio.read") for group in requests) / len(requests)
