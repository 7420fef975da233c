"""Readings of a cell's compared numbers for their limits: sound runs of
the program, and the controls and faults (see port_bench/calibrate.py)."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from . import asr, bench, spec, traffic

# what each entry's controls put in the program's place (see calibrate.py)
CONTROLS = {"asr_batch": ("fp8", "second_best"), "asr_request": ("fp8", "second_best"),
            "llm_enrich": ("int4_activations",)}


def _window(entry, seed: int, calls: int) -> list:
    """`calls` calls of the entry's pool in the run's order (the whole
    pool once when 0), as a run's window makes them."""
    order = traffic.cycle_order(len(entry.pool), seed)
    done = []
    for index in range(calls or len(order)):
        k = order[index % len(order)]
        start = time.perf_counter()
        entry.run(k)
        end = time.perf_counter()
        done.append(bench.Call(index, k, start, end, True, entry.record(index, k)))
    return done


def readings(root: str, workload: str, seed: int, calls: int, control: bool,
             device: str = "cuda", data_dir: str | None = None) -> dict:
    specs = spec.Spec(root)
    wl = specs.workload(workload)
    data_dir = data_dir or spec.BENCH_DIR
    mix = spec.traffic(wl["traffic"], data_dir)
    if device == "cuda":
        from turbo_whisper_workspace_tpu_torch.ops import build

        build.build_all()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cfg = specs.config(wl)
    cell = spec.cell(workload, data_dir)
    module = spec.entry(mix["entry"])
    e = module.Entry(SimpleNamespace(device=dev, seed=seed, config=cfg, traffic=mix, cell=cell,
                                     tracing=False))
    e.warm_up()
    out = {"workload": workload, "seed": seed}
    done = _window(e, seed, calls)
    out["calls"] = len(done)
    samples = e.samples(done)
    e.release()
    e.close()
    judge = asr.check if mix["entry"].startswith("asr") else module.check
    for name in ("program", *(CONTROLS[mix["entry"]] if control else ())):
        checks = judge(cfg, seed, dev, samples, cell["limits"],
                       control=None if name == "program" else name)
        # the same verdict a run gives, with every call finished
        out[name] = {"correct": bench.verdict(checks, 0), "checks": checks}
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["kind"] = torch.cuda.get_device_name(dev)
    return out
