"""The device's side of a traced run, read from torch.profiler.

The profiler runs over whole calls of the window (the traced window);
the benchmark marks that window and each call with `record_function`
annotations. From the raw trace (kineto events: no per-event Python
objects beyond these tuples) it keeps the device operations (kernels,
copies, sets) and the host's annotations, operators and runtime calls,
and derives:

* busy: the union of device-operation intervals inside the window;
* time by kernel name (the share of a roofline reads it);
* idle gaps: the spans of the window no device operation covers, each
  named by what the host was doing in it (the innermost annotation or
  operator open at the gap's middle).

Same arithmetic as `chip_smoke.py`'s step profiles (device time by
kernel, busy against the host's wall), from its own copy here.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "port_bench.window"


class Trace:
    def __init__(self, device_ops: list[tuple[str, int, int]],
                 host_ops: list[tuple[str, int, int]], window: tuple[int, int]):
        """device_ops and host_ops: (name, start_ns, end_ns); window: the
        traced window's (start_ns, end_ns)."""
        w0, w1 = window
        self.window_ns = (w0, w1)
        self.device_ops = [(n, max(a, w0), min(b, w1)) for n, a, b in device_ops
                           if b > w0 and a < w1]
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self._starts = [e[1] for e in self.host_ops]
        self.busy_intervals = self._union([(a, b) for _, a, b in self.device_ops])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """From the profiler's raw events. A device event that bears the
        name of a host annotation is that annotation's shadow on the
        device's timeline, not an operation, and is left out."""
        from torch.autograd import DeviceType

        device, host, window = [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
            length = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
            if e.device_type() == DeviceType.CUDA:
                device.append((name, start, start + length))
            elif name == WINDOW:
                window = (start, start + length)
            else:
                host.append((name, start, start + length))
        if window is None:
            raise ValueError(f"the trace has no {WINDOW!r} annotation")
        names = {h[0] for h in host} | {WINDOW}
        return cls([d for d in device if d[0] not in names], host, window)

    @staticmethod
    def _union(intervals):
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_time(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name contains
        `pattern`."""
        total, count = 0, 0
        for name, a, b in self.device_ops:
            if pattern in name:
                total += b - a
                count += 1
        return total / 1e9, count

    def by_name(self) -> dict[str, float]:
        out = defaultdict(float)
        for name, a, b in self.device_ops:
            out[name] += (b - a) / 1e9
        return out

    def gaps(self) -> list[tuple[int, int]]:
        w0, w1 = self.window_ns
        edges = [w0] + [x for iv in self.busy_intervals for x in iv] + [w1]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_at(self, t: int) -> str:
        """The innermost host annotation or operator open at time t."""
        # sorted by start: the first event back from t that is still
        # open at t is the one that started last, the innermost
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            name, _, end = self.host_ops[i]
            if end >= t:
                return name
        return "(no host event)"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        by_host = defaultdict(float)
        for a, b in gaps[:2000]:
            by_host[self.host_at((a + b) // 2)] += (b - a) / 1e9
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in idle]}
