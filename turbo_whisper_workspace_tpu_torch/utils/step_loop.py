"""Decode loops as device programs: one step captured in a CUDA graph.

The JAX package compiles each decode loop into one `lax.while_loop`
under jit (`decode/greedy.py`, `llm/generate.py`): the step's ops, the
position and the stop test all stay on the device. Here a loop's step is
a Python function over static buffers, the state tensors it updates in
place (the step counter, and so the position, among them). `run_steps`
calls it up to `n_steps` times and stops once every row has finished,
which the host reads before the first step and then after every `every`
steps (a pinned copy after an event on a CUDA device).

* graphed (the default on a CUDA device): the step runs once eagerly on
  a side stream as a warm-up, with the state put back afterwards
  (kernel attributes and cuBLAS workspaces are set up outside the
  graph), then one call is captured into a
  `torch.cuda.CUDAGraph` on that stream and replayed on the caller's
  stream, with no Python dispatch in between. A step that fails to
  capture or replay raises; nothing falls back to the eager loop.
* eager (`graphed=False`; the default on the CPU, with the flag read
  every step): the same function called each step, on any device. On
  the card it is the witness that the graph is that function.

A step must freeze finished rows (pad their tokens, leave their scores),
as the JAX loop's body does, so the steps a graphed run makes after its
last row finished, before the host next reads the flag, change no
result. Kernel wrappers count a launch when they launch; a capture
launches nothing, so while a thread captures, its wrappers' counts go to
the graph's record (`ops/build.count_launch`), which every replay
adds: `launch_counts` stays the number of kernels run on the card, with
other threads' launches and replays kept apart from the capture.

Spans (`utils/profiling.py`): `step_loop.capture` over a graph's
warm-up, capture and instantiation, `step_loop.loop` from the first
step to the last stop read (`steps`), and `step_loop.stop_read` over
each read of the flag. The loop ends on a read, also after its last
step, so no step it queued is still running on the card when its span
closes. None is opened inside a step: a replay stays one graph launch.
"""

from __future__ import annotations

import torch

from ..ops import build
from . import profiling


class StepGraph:
    """`step()` captured once into a CUDA graph over `state`'s buffers.

    `generator`, when the step draws from it, is registered with the
    graph, so each replay advances it and draws new noise."""

    def __init__(self, step, state: dict, generator: torch.Generator | None = None):
        device = next(iter(state.values())).device
        with profiling.span("step_loop.capture", timed=True) as span:
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                # warm-up on the capture stream, then the state put back: the
                # cache rows it wrote are written again, equal, by the first replay
                saved = {name: t.clone() for name, t in state.items()}
                rng = generator.get_state() if generator is not None else None
                step()
                for name, t in state.items():
                    t.copy_(saved[name])
                if rng is not None:
                    generator.set_state(rng)
                del saved
                self.graph = torch.cuda.CUDAGraph()
                if generator is not None:
                    self.graph.register_generator_state(generator)
                # thread_local: another thread's allocations (a concurrent
                # request of the server) do not break this capture
                self.graph.capture_begin(capture_error_mode="thread_local")
                build.capture.record = self.launches = {}
                try:
                    step()
                finally:
                    build.capture.record = None
                    self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(stream)
        self.capture_s = span.seconds

    def replay(self) -> None:
        self.graph.replay()
        for name, (counts, n) in self.launches.items():
            counts[name] += n


class _StopFlag:
    """`finished.all()` read on the host: through a pinned copy after an
    event on a CUDA device."""

    def __init__(self, finished: torch.Tensor):
        self.finished = finished
        self.pinned = self.event = None
        if finished.is_cuda:
            self.pinned = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()

    def read(self) -> bool:
        with profiling.span("step_loop.stop_read"):
            if self.pinned is None:
                return bool(self.finished.all())
            self.pinned.copy_(self.finished.all(), non_blocking=True)
            self.event.record()
            self.event.synchronize()
            return bool(self.pinned)


def run_steps(step, state: dict, n_steps: int, every: int, graphed: bool | None,
              generator: torch.Generator | None = None,
              timings: dict | None = None) -> int:
    """Call `step()` (or replay its graph) until every row of
    `state["finished"]` is set, as read before the first step, after
    every `every` steps and after the last, or `n_steps` steps ran. Returns the steps run.
    graphed: None graphs the step on a CUDA device and runs it eagerly
    on the CPU with the flag read every step; False runs it eagerly (at
    `every`); True graphs it (CUDA only). `timings`, when given,
    receives the graph's `capture_s` (warm-up, capture and
    instantiation; 0 when eager) and `loop_s`, the wall of the steps
    after it, ending in a device sync."""
    flag = _StopFlag(state["finished"])
    if graphed is None:
        graphed = flag.finished.is_cuda
        every = every if graphed else 1
    if graphed and not flag.finished.is_cuda:
        raise ValueError(f"a CUDA graph needs CUDA tensors, got {flag.finished.device}")
    if timings is not None:
        timings["capture_s"] = timings["loop_s"] = 0.0
    if n_steps <= 0 or flag.read():
        return 0
    run = step
    if graphed:
        graph = StepGraph(step, state, generator)
        run = graph.replay
        if timings is not None:
            timings["capture_s"] = graph.capture_s
    done = 0
    with profiling.span("step_loop.loop", timed=timings is not None) as span:
        while True:
            n = min(every, n_steps - done)
            for _ in range(n):
                run()
            done += n
            if flag.read() or done == n_steps:
                break
        if timings is not None and flag.finished.is_cuda:
            torch.cuda.synchronize(flag.finished.device)
        span.set(steps=done)
    if timings is not None:
        timings["loop_s"] = span.seconds
    return done
