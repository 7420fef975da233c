"""One run of one cell: set-up, the measured window, the metrics, the check.

A cell's traffic mix names the entry (`entries/<entry>.py`) that drives
the port; its `Entry(ctx)` builds the system and its inputs (set-up),
`warm_up()` runs the cell's shapes once, `run(k)` makes pool call k and
`record(index, k)` returns its work, and after the window `check(calls)`
frees the port and compares what it served with the reference. With
`--trace 1` the entry's `instrument()` (where it has one) adds its
spans, the harness wraps the kernel of each roofline metric the cell
reports (`metrics/<kernel>_roofline.py`: `KERNEL`, `cost`), and the
first `trace_calls` calls of the window run under torch.profiler.

The window's arrivals are the mix's (`traffic.arrivals`): a closed loop,
where each of `callers` callers starts its next call as its last returns
while fewer than `seconds` have passed since the window opened (the last
may run past), or an open loop, where calls arrive at times drawn from
the mix and wait for a free caller; a call's latency runs from its
arrival. Calls run in the main thread where there is one caller.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import resource
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from types import SimpleNamespace

from . import costs, spec, trace, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "turbo_whisper_workspace_tpu"}


@dataclass
class Call:
    index: int
    pool: int
    start: float
    end: float
    ok: bool
    work: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What a metric's reader reads (`metrics/<name>.py: read(run)`)."""

    workload: str
    config: dict
    entry: object
    setup_s: float
    window_start: float
    calls: list[Call]
    traced: list[Call] = field(default_factory=list)
    trace: trace.Trace | None = None
    costs: dict = field(default_factory=dict)

    @property
    def finished(self) -> list[Call]:
        return [c for c in self.calls if c.ok]

    @property
    def window_s(self) -> float:
        return self.calls[-1].end - self.window_start if self.calls else 0.0

    def rate(self, key: str) -> float | None:
        """All the work `key` of the calls that finished, over the window."""
        done = self.finished
        if not done or self.window_s <= 0:
            return None
        return sum(c.work[key] for c in done) / self.window_s

    def latency_ms(self, q: float) -> float | None:
        """The q-th percentile (linear) of the calls' latencies."""
        lat = sorted(c.seconds * 1e3 for c in self.finished)
        if not lat:
            return None
        x = (len(lat) - 1) * q / 100.0
        lo = math.floor(x)
        hi = min(lo + 1, len(lat) - 1)
        return lat[lo] + (lat[hi] - lat[lo]) * (x - lo)

    def idle_share(self) -> float | None:
        return None if self.trace is None else 100.0 * self.trace.idle_share()

    def mfu(self) -> float | None:
        """Model FLOPs of the traced calls over the traced window, against
        the H100's bf16 peak, in %."""
        if self.trace is None or not self.traced:
            return None
        flops = sum(self.entry.call_flops(c.index, c.pool) for c in self.traced)
        return 100.0 * flops / self.trace.window_s / costs.PEAK_BF16_FLOPS

    def roofline(self, kernel: dict) -> float | None:
        """The share of its roofline a metric's kernel (its KERNEL)
        reached in the traced window: the least time its launches could
        take (the metric's `cost` of their shapes) over the device time of
        the trace's kernels named like kernel["trace"], in %. None where
        it did not run, or where the launches recorded and traced
        disagree."""
        key = costs.kernel_key(kernel)
        if self.trace is None or key not in self.costs:
            return None
        launches, _, _, bound = self.costs[key]
        seconds, count = self.trace.kernel_time(kernel["trace"])
        if count == 0 or seconds <= 0:
            return None
        if count != launches:
            print(f"roofline {key}: {launches} launches recorded, {count} traced; "
                  "not reported", file=sys.stderr)
            return None
        return 100.0 * bound / seconds


def verdict(checks: list[dict], failed: int) -> bool:
    """`correct`: every call finished, and every number compared is
    finite and within its limit."""
    return failed == 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)


class HostClock:
    """What the host did during a call, for the stderr record: the
    process's CPU seconds, the machine's stolen CPU seconds (/proc/stat),
    involuntary context switches, page faults, the seconds Python's
    garbage collector ran, and the device allocator's retries, cudaMalloc
    calls and reserved bytes. Process- and machine-wide: with several
    callers, a call's numbers include the others'."""

    def __init__(self, device):
        self.device = device if device.type == "cuda" else None
        self.tick = os.sysconf("SC_CLK_TCK")
        self.gc_s, self._gc_start = 0.0, 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_start

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)

    def sample(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out = {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
               "majflt": ru.ru_majflt, "minflt": ru.ru_minflt, "gc_s": self.gc_s}
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()
            out["steal_s"] = int(fields[8]) / self.tick
        except (OSError, IndexError, ValueError):
            pass
        if self.device is not None:
            import torch

            st = torch.cuda.memory_stats(self.device)
            out.update(alloc_retries=st.get("num_alloc_retries", 0),
                       device_allocs=st.get("num_device_alloc", 0),
                       reserved_gb=st.get("reserved_bytes.all.current", 0) / 2**30)
        return out

    @staticmethod
    def delta(a: dict, b: dict) -> dict:
        return {k: (b[k] if k == "reserved_gb" else b[k] - a[k]) for k in b if k in a}


def card(device) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=30)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float, tracing: bool,
             t_start: float, device: str = "cuda", data_dir: str = spec.BENCH_DIR) -> int:
    """Runs the cell, prints its result line last on stdout; returns the
    exit code. device="cpu" (tests) skips the look for a card; data_dir
    (tests) holds the traffic/ and cells/ files in place of port_bench/."""
    import torch

    specs = spec.Spec(root)
    wl = specs.workload(workload)
    mix = spec.traffic(wl["traffic"], data_dir)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            print(f"{workload} needs {wl['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        from turbo_whisper_workspace_tpu_torch.ops import build

        build.build_all()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    ctx = SimpleNamespace(device=dev, seed=seed, config=specs.config(wl), traffic=mix,
                          cell=spec.cell(workload, data_dir), tracing=tracing)
    entry = spec.entry(mix["entry"]).Entry(ctx)
    try:
        return _measure(specs, workload, entry, ctx, seconds, tracing, t_start)
    finally:
        entry.close()


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(run: Run, entry, order: list[int], arrivals: list[float] | None, callers: int,
            seconds: float, clock: HostClock, tracing: bool,
            after=None) -> list[threading.Thread]:
    """Makes the window's calls into run.calls (in the order they end),
    from run.window_start: a closed loop when arrivals is None, else one
    call at each arrival offset. after(n), where given, runs when the
    n-th call has ended, before its caller takes another. One caller runs
    in this thread, and this returns when the window is done; several run
    in threads of their own, returned started, for the caller to join."""
    from torch.profiler import record_function

    lock = threading.Lock()
    taken = [0]

    def take() -> int | None:
        with lock:
            i = taken[0]
            if arrivals is None:
                if i and time.perf_counter() - run.window_start >= seconds:
                    return None
            elif i >= len(arrivals):
                return None
            taken[0] += 1
            return i

    def caller() -> None:
        while (index := take()) is not None:
            k = order[index % len(order)]
            if arrivals is not None:
                start = run.window_start + arrivals[index]
                time.sleep(max(0.0, start - time.perf_counter()))
            else:
                start = time.perf_counter()
            before = clock.sample()
            try:
                with (record_function(f"port_bench.call {index}") if tracing
                      else contextlib.nullcontext()):
                    entry.run(k)
                end = time.perf_counter()
                call = Call(index, k, start, end, True, entry.record(index, k))
            except Exception:                  # noqa: BLE001 - a call that fails is counted
                end = time.perf_counter()
                traceback.print_exc()
                call = Call(index, k, start, end, False)
            call.host = HostClock.delta(before, clock.sample())
            with lock:
                run.calls.append(call)
                n = len(run.calls)
            if after is not None:
                after(n)

    if callers == 1:
        caller()
        return []
    threads = [threading.Thread(target=caller, name=f"port_bench.caller {i}")
               for i in range(callers)]
    for t in threads:
        t.start()
    return threads


def _measure(specs, workload, entry, ctx, seconds, tracing, t_start) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    dev, mix = ctx.device, ctx.traffic
    entry.warm_up()
    recorder = None
    if tracing:
        if hasattr(entry, "instrument"):
            entry.instrument()
        recorder = costs.CostRecorder()
        for name in specs.metric_names(workload, end_to_end=False):
            module = spec.metric(name)
            if hasattr(module, "KERNEL"):
                recorder.wrap_kernel(module.KERNEL, module.cost)
        recorder.wrap_step_graph()
    order = traffic.cycle_order(len(entry.pool), ctx.seed)
    arrivals, callers = traffic.arrivals(mix, seconds)
    clock = HostClock(dev)
    _sync(dev)
    run = Run(workload=workload, config=ctx.config, entry=entry, setup_s=0.0,
              window_start=0.0, calls=[])
    prof = window_mark = None
    n_traced = mix["trace_calls"] if tracing else 0
    if n_traced:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.__enter__()
        window_mark = record_function(trace.WINDOW)
        window_mark.__enter__()
        recorder.on = True

    tracing_on = [prof is not None]

    def stop_tracing() -> None:
        if not tracing_on[0]:
            return
        tracing_on[0] = False
        _sync(dev)
        recorder.on = False
        window_mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        run.traced = list(run.calls)

    # with several callers, the caller that ends the last traced call
    # waits while the main thread closes the profiler
    reached, closed = threading.Event(), threading.Event()

    def after(n: int) -> None:
        if n != n_traced:
            return
        if callers == 1:
            stop_tracing()
        else:
            reached.set()
            closed.wait()

    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - t_start
    threads = _window(run, entry, order, arrivals, callers, seconds, clock, tracing,
                      after if n_traced else None)
    if threads and n_traced:
        while not reached.wait(0.05) and any(t.is_alive() for t in threads):
            pass
        stop_tracing()
        closed.set()
    for t in threads:
        t.join()
    clock.close()
    stop_tracing()
    _sync(dev)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if prof is not None:
        recorder.restore()
        run.trace = trace.Trace.from_profiler(prof)
        run.costs = dict(recorder.totals)
        del prof
    elif recorder is not None:
        recorder.restore()

    metrics = {}
    for name in specs.metric_names(workload, end_to_end=not tracing):
        value = spec.metric(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": specs.metrics[name]["unit"]}
    device = card(dev) if dev.type == "cuda" else {"platform": "cpu", "kind": "cpu"}
    device.update(count=1, memory_peak_bytes=memory_peak)
    breakdown = None
    if run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = run.trace.breakdown()

    attempted = len(run.calls)
    failed = attempted - len(run.finished)
    try:
        checks = entry.check(run.finished) if run.finished else []
    except Exception:                          # noqa: BLE001 - a check that fails is not correct
        traceback.print_exc()
        checks = [{"name": "check", "value": float("inf"), "limit": 0.0}]
    correct = verdict(checks, failed)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the process loaded {loaded}; the benchmark runs the port alone", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a number that is not finite is written as a string: strict JSON has no inf
    result["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(c["value"])
                                    else str(c["value"]), "limit": c["limit"]}
                        for c in checks}
    print(json.dumps({"calls": [[c.pool, c.seconds, c.work, c.host] for c in run.calls],
                      "checks": checks, "seed": ctx.seed}, default=str), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
