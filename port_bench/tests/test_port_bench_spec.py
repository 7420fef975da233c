"""BENCHMARK.json: its keys, names and units, and every file a cell
names resolves by name."""

import os
import re

import pytest

from port_bench.lib import spec

ROOT = os.path.dirname(spec.BENCH_DIR)
BENCH = spec.Spec(ROOT)
DATA = BENCH.data
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")


def test_top_level_keys_and_limits():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "port_bench/run.py"]
    assert DATA["paths"] == ["port_bench"]
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_exactly_their_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("name", [c["name"] for c in DATA["configs"]]
                         + [w["name"] for w in DATA["workloads"]]
                         + [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
                         + [w["config"] for w in DATA["workloads"]]
                         + [w["traffic"] for w in DATA["workloads"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_units_texts_and_uniqueness():
    metrics = DATA["end_to_end"] + DATA["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert LINE.match(m.get("layer", "x"))
    for w in DATA["workloads"]:
        assert LINE.match(w["why"])
    for c in DATA["configs"]:
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for group in (DATA["configs"], DATA["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in DATA["workloads"]:
        e2e = BENCH.metric_names(w["name"], end_to_end=True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert BENCH.metric_names(w["name"], end_to_end=False)


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    cells = {w["name"] for w in DATA["workloads"]}
    for m in DATA["per_layer"]:
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in BENCH.metric_names(cell, end_to_end=True)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_every_file_of_a_cell_resolves_by_name(cell):
    w = BENCH.workload(cell)
    cfg_file = BENCH.configs[w["config"]]["file"]
    assert cfg_file.startswith("port_bench/")
    cfg = BENCH.config(w)
    assert cfg["source"].rstrip("/").startswith(BENCH.configs[w["config"]]["source"])
    assert cfg["reduced"] == BENCH.configs[w["config"]]["reduced"]
    mix = spec.traffic(w["traffic"])
    assert hasattr(spec.entry(mix["entry"]), "Entry")
    assert spec.cell(cell)["limits"]
    for name in BENCH.metric_names(cell, True) + BENCH.metric_names(cell, False):
        assert callable(spec.metric(name).read)


def test_the_benchmarks_folder_holds_only_its_own_files():
    for dirpath, _, files in os.walk(spec.BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", rel), rel
