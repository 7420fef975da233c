"""The port's tracer: program spans on torch.profiler's timeline.

A span is on exactly while a `torch.profiler.profile` records (the
benchmark's traced window, or `trace()` below); there is no other
switch. With the profiler off, `span()` reads one flag and returns a
shared no-op, unless the caller asks for its duration (`timed=True`:
two clock reads, nothing recorded).

With the profiler on, a span

* opens a `torch.profiler.record_function(name)` annotation (its C++
  form, `_RecordFunctionFast`, where torch has it: a small fraction of
  the Python form's cost, and its stamps lie closer to the span's own),
  so it sits on the profiler's timeline and names the host work (and
  the device's idle gaps) below it. Names are fixed strings: a span's
  shadow on the device's timeline then bears the name of a host event;
* appends a `SpanRecord` at its end: name, start and end in ns, its
  parent span, its request and its attributes. Start and end are read
  on the clock the profiler stamps its events with, the wall clock
  (`time.time_ns`; `tests/test_torch_tracing.py` holds the two within
  50 µs), so spans can be laid over the trace's events.

The request of a span is its outermost open span's: a span opened with
no span open in its context (a `contextvars` value, so each thread and
each task has its own) starts a new request. Counts (windows, steps)
are a span's attributes, given when it opens or by `set()` before it
closes. `spans()` returns what was recorded and
`clear_spans()` empties it; the record lives in memory, for whoever
ended the trace to read.

Where a loop keeps a `timings` dict, the span over the same interval is
its clock (`Span.seconds`): one measurement, also with tracing off.

A counter is a device buffer the program adds to while the profiler
records (`counter()` gives it, zeroed at first use, or None when the
profiler is off): device ops only, never a host read, so a count costs
one small launch; `counters()` returns them for whoever ended the trace,
and `clear_spans()` drops them with the spans.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

# the profiler's clock (torch 2.11 and 2.13 stamp its events in wall-clock ns)
clock_ns = time.time_ns
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.profiler.record_function

_records: list["SpanRecord"] = []
_counters: dict[str, torch.Tensor] = {}
_ids = itertools.count(1)
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "turbo_whisper_span", default=None)


@dataclass(frozen=True)
class SpanRecord:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None       # the enclosing span's id
    request: int             # the outermost enclosing span's id
    attrs: dict = field(default_factory=dict)


class Span:
    """One open span; `with span(...) as s` gives it."""

    __slots__ = ("name", "attrs", "traced", "start_ns", "end_ns", "id", "parent",
                 "request", "_rf", "_token")

    def __init__(self, name: str, attrs: dict, traced: bool):
        self.name, self.attrs, self.traced = name, attrs, traced

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        if self.traced:
            outer = _current.get()
            self.id = next(_ids)
            self.parent = None if outer is None else outer.id
            self.request = self.id if outer is None else outer.request
            self._token = _current.set(self)
            self._rf = _annotation(self.name)
            self._rf.__enter__()
        self.start_ns = clock_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = clock_ns()
        if not self.traced:
            return
        self._rf.__exit__(*exc)
        _current.reset(self._token)
        _records.append(SpanRecord(self.name, self.start_ns, self.end_ns, self.id, self.parent,
                                   self.request, self.attrs))


class _Off:
    """The span while the profiler is off."""

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, *, timed: bool = False, **attrs):
    """A span named `name` (a fixed string) with `attrs`. Recorded only
    while the profiler records; `timed` measures its `seconds` even
    when it is not."""
    traced = _autograd_profiler._is_profiler_enabled
    if not (traced or timed):
        return _OFF
    return Span(name, attrs, traced)


def spans() -> list[SpanRecord]:
    """The spans recorded, in the order they ended."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()
    _counters.clear()


def counter(name: str, shape: tuple, device) -> torch.Tensor | None:
    """The counter `name` (an int64 device buffer of `shape`, zeros at
    first use) while the profiler records; None when it does not."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    buf = _counters.get(name)
    if buf is None:
        buf = _counters[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return buf


def counters() -> dict[str, torch.Tensor]:
    """The counters recorded, by name."""
    return dict(_counters)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "twt_trace")):
    """torch.profiler capture of the block (CUDA activity too when a card
    is present); writes `<log_dir>/trace.json` (Chrome trace format, for
    chrome://tracing or Perfetto), whose annotations include the
    program's spans, and yields the profiler. `spans()` then holds the
    block's spans."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
