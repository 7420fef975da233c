"""Tracing / profiling: stage timers, device traces, kernel accounting.

Port of turbo_whisper_workspace_tpu/utils/profiling.py:

* `StageTimer`: context-manager timers producing the reference's
  processing_times dict (plus a realtime factor), copied;
* `trace`: a torch.profiler capture (CPU and, where there is one, CUDA
  activity) around a block, written as a Chrome trace into `log_dir`;
* `speed_of_light`: roofline accounting for a callable, timed with CUDA
  events around a device sync when its inputs live on a card, with
  `time.perf_counter` on the CPU.

The peaks are one NVIDIA H100 SXM's, not the JAX package's TPU figures.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity, at the 700 W
# limit); a card set to a lower power limit reaches less
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_S = 3.35e12


class StageTimer:
    """Accumulates named stage durations; produces the reference's
    processing_times dict."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def finish(self) -> dict[str, float]:
        self.times["total"] = time.time() - self._t0
        return dict(self.times)

    def realtime_factor(self, audio_seconds: float) -> float:
        total = self.times.get("total") or (time.time() - self._t0)
        return total / audio_seconds if audio_seconds else 0.0


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "twt_trace")):
    """torch.profiler capture of the block (CUDA activity too when a card
    is present); writes `<log_dir>/trace.json` (Chrome trace format, for
    chrome://tracing or Perfetto) and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class KernelRoofline:
    name: str
    seconds: float
    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_flops: float = PEAK_BF16_FLOPS
    peak_bytes_s: float = PEAK_HBM_BYTES_S
    extra: dict = field(default_factory=dict)

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds if self.seconds else 0.0

    @property
    def achieved_bytes_s(self) -> float:
        return self.bytes_accessed / self.seconds if self.seconds else 0.0

    @property
    def sol_time(self) -> float:
        """Speed-of-light time: max of compute-bound and bandwidth-bound."""
        return max(self.flops / self.peak_flops,
                   self.bytes_accessed / self.peak_bytes_s)

    @property
    def sol_fraction(self) -> float:
        return self.sol_time / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return (
            f"{self.name}: {self.seconds * 1e3:.2f} ms | "
            f"{self.achieved_flops / 1e12:.1f} TF/s "
            f"({100 * self.achieved_flops / self.peak_flops:.0f}% peak) | "
            f"{self.achieved_bytes_s / 1e9:.0f} GB/s "
            f"({100 * self.achieved_bytes_s / self.peak_bytes_s:.0f}% peak) | "
            f"SoL {100 * self.sol_fraction:.0f}%"
        )


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def speed_of_light(name: str, fn, *args, flops: float = 0.0,
                   bytes_accessed: float = 0.0, iters: int = 5) -> KernelRoofline:
    """Time `fn(*args)` (one warm-up call, then `iters` calls) and report
    roofline numbers. On a card: CUDA events around the calls and a sync
    before reading them; on the CPU: the host clock."""
    out = _first_tensor(fn(*args))
    cuda = out is not None and out.is_cuda
    if cuda:
        torch.cuda.synchronize(out.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        seconds = (time.perf_counter() - t0) / iters
    return KernelRoofline(name=name, seconds=seconds, flops=flops,
                          bytes_accessed=bytes_accessed)
