"""The program's own spans, as the port's tracer recorded them.

`utils/profiling.py` of the port records a span at each of its layer
boundaries while torch.profiler records, so after a traced run its
`spans()` holds exactly the traced calls' spans: name, start and end
(ns, on the profiler's clock), the enclosing span's id, the request (the
outermost span's id) and the attributes. A port without that tracer
gives no spans, and every reader here then gives None.

Self time: a span's wall less the part of it that its listed children
(direct children of the given names) cover, overlaps counted once.
"""

from __future__ import annotations

from collections import defaultdict


def records() -> list:
    """The port's recorded spans; [] where the port has no tracer."""
    from turbo_whisper_workspace_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return list(spans()) if spans is not None else []


def traced(run) -> list:
    """The spans inside the run's traced window (spans and trace share
    the profiler's clock), so no other trace's spans in the process count."""
    if run.trace is None:
        return []
    w0, w1 = run.trace.window_ns
    return [s for s in records() if w0 <= s.start_ns and s.end_ns <= w1]


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def by_request(spans: list) -> dict[int, list]:
    """The spans of each request id, in the order they ended."""
    out = defaultdict(list)
    for s in spans:
        out[s.request].append(s)
    return dict(out)


def covered_ns(intervals, lo: int, hi: int) -> int:
    """The length of [lo, hi] that the union of `intervals` covers."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def self_ns(span, spans: list, children: tuple[str, ...]) -> int:
    """The span's wall less what its direct children named in `children`
    cover."""
    kids = [(s.start_ns, s.end_ns) for s in spans
            if s.parent == span.id and s.name in children]
    return span.end_ns - span.start_ns - covered_ns(kids, span.start_ns, span.end_ns)


def wall_ms(spans: list, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in named(spans, name)) / 1e6


def self_ms(spans: list, name: str, children: tuple[str, ...]) -> float:
    """Self time of every span called `name`, summed, in ms."""
    return sum(self_ns(s, spans, children) for s in named(spans, name)) / 1e6


def per_call(spans: list, name: str, calls: int) -> float | None:
    """The wall of the spans called `name`, in ms, over `calls`: 0 where
    the program traced its calls and none ran (an eager loop captures
    nothing); None where there are no spans or no calls."""
    return wall_ms(spans, name) / calls if spans and calls else None


def host_ms_per_window(spans: list) -> float | None:
    """The transcriber's own time a window: `transcriber.transcribe`
    less its encode, detect and decode children, over its windows."""
    windows = sum(s.attrs.get("windows", 0) for s in named(spans, "transcriber.transcribe"))
    if not windows:
        return None
    return self_ms(spans, "transcriber.transcribe",
                   ("transcriber.encode", "transcriber.detect", "transcriber.decode")) / windows
