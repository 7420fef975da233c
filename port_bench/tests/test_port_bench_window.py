"""The window's arrival processes, driven by a fake entry on the CPU: a
closed loop of one caller, and an open loop whose calls wait for a free
caller and count their latency from their arrival."""

import threading
import time

import pytest
import torch

from port_bench.lib import bench, traffic


class Sleeper:
    """An entry whose call k sleeps `service` seconds; records who ran it."""

    def __init__(self, service: float):
        self.service, self.pool, self.threads = service, [0, 1, 2], set()

    def run(self, k: int) -> None:
        self.threads.add(threading.current_thread().name)
        time.sleep(self.service)

    def record(self, index: int, k: int) -> dict:
        return {"items": 1}


def window(entry, mix, seconds, after=None):
    run = bench.Run(workload="w", config={}, entry=entry, setup_s=0.0,
                    window_start=time.perf_counter(), calls=[])
    arrivals, callers = traffic.arrivals(mix, seconds)
    clock = bench.HostClock(torch.device("cpu"))
    threads = bench._window(run, entry, [0, 1, 2], arrivals, callers, seconds, clock, False,
                            after)
    for t in threads:
        t.join()
    clock.close()
    return run, arrivals


def test_a_closed_loop_starts_calls_while_the_window_is_open():
    entry = Sleeper(0.02)
    ends = []
    run, arrivals = window(entry, {"arrivals": {"process": "closed", "callers": 1}}, 0.1,
                           after=ends.append)
    assert arrivals is None
    assert 4 <= len(run.calls) <= 7
    assert ends == list(range(1, len(run.calls) + 1))
    assert entry.threads == {threading.main_thread().name}
    assert all(c.ok and c.seconds >= 0.02 for c in run.calls)
    assert run.calls[-2].start - run.window_start < 0.1 <= run.window_s + 0.02
    assert {"cpu_s", "nivcsw", "gc_s", "majflt"} <= set(run.calls[0].host)


def test_an_open_loop_serves_every_arrival_and_counts_the_wait():
    mix = {"arrivals": {"process": "poisson", "rate_per_s": 200.0, "callers": 2, "seed": 5}}
    entry = Sleeper(0.02)
    run, arrivals = window(entry, mix, 0.2)
    # 200 a second over 0.2 s, from the mix's seed: the same for every run
    assert 20 <= len(arrivals) <= 60 and arrivals == traffic.arrivals(mix, 0.2)[0]
    assert sorted(c.index for c in run.calls) == list(range(len(arrivals)))
    for c in run.calls:
        assert c.start == pytest.approx(run.window_start + arrivals[c.index])
        assert c.seconds >= 0.02                       # service, and the wait before it
    # two callers at 0.02 s each cannot keep up with 200 a second: the queue grows
    assert max(c.seconds for c in run.calls) > 0.1
    assert len(entry.threads) == 2


def test_arrival_processes_from_the_mix():
    assert traffic.arrivals({}, 10.0) == (None, 1)
    assert traffic.arrivals({"arrivals": {"process": "closed", "callers": 3}}, 10.0) == (None, 3)
    times, callers = traffic.arrivals(
        {"arrivals": {"process": "poisson", "rate_per_s": 5.0, "callers": 1, "seed": 1}}, 100.0)
    assert callers == 1 and times == sorted(times) and times[-1] < 100.0
    assert 400 <= len(times) <= 600
    with pytest.raises(ValueError):
        traffic.arrivals({"arrivals": {"process": "bursty"}}, 1.0)
