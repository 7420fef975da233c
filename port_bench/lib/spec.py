"""The benchmark's description, and the files each cell names.

`BENCHMARK.json` at the checkout's root names the cells, the
configurations and the metrics. Everything that belongs to one of them
is a file of its own under `port_bench/`, found by name:

* a configuration: `configs/<config>.json` (its `file` in BENCHMARK.json);
* a traffic mix: `traffic/<traffic>.json`, read by `lib/traffic.py`; its
  `entry` names `entries/<entry>.py`, the module that drives the port;
* a cell's correctness sample and limits: `cells/<workload>.json`;
* a metric: `metrics/<metric>.py`, whose `read(run)` returns its value or
  None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at `path` as a fresh module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """BENCHMARK.json of the checkout at `root`, with lookups by name."""

    def __init__(self, root: str):
        self.root = root
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.metrics = {m["name"]: m for m in self.data["end_to_end"] + self.data["per_layer"]}

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(self.workloads)}")
        return self.workloads[name]

    def config(self, workload: dict) -> dict:
        """The configuration file of the workload's configuration."""
        return load_json(os.path.join(self.root, self.configs[workload["config"]]["file"]))

    def metric_names(self, workload: str, end_to_end: bool) -> list[str]:
        """The metrics a run of `workload` reports: end-to-end ones with
        --trace 0, per-layer ones with --trace 1."""
        group = self.data["end_to_end"] if end_to_end else self.data["per_layer"]
        return [m["name"] for m in group if workload in m.get("workloads", [workload])]


def traffic(name: str, data_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(data_dir, "traffic", f"{name}.json"))


def cell(name: str, data_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(data_dir, "cells", f"{name}.json"))


def entry(name: str):
    return load_module(os.path.join(BENCH_DIR, "entries", f"{name}.py"),
                       f"port_bench_entry_{name}")


def metric(name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                       "port_bench_metric_" + re.sub(r"\W", "_", name))
