"""On the card: one short run of each cell through the command the
driver runs, its result line held to the contract. Skipped without a
CUDA device."""

import json
import os
import subprocess
import sys

import pytest

from port_bench.lib import spec

ROOT = os.path.dirname(spec.BENCH_DIR)
CELLS = [w["name"] for w in spec.Spec(ROOT).data["workloads"]]
# a window long enough for what the check samples: the LLM cell judges
# the greedy conversations, every third of its pool of six (3.5 s each)
SECONDS = {"mistral7b-enrich": 25}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_meets_the_contract(card, cell):
    args = ["--workload", cell, "--seed", str(2**31 + 17), "--seconds",
            str(SECONDS.get(cell, 2)), "--trace", "0"]
    out = subprocess.run([sys.executable, "port_bench/run.py", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["device"]["memory_peak_bytes"] > 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert list(result)[-1] == "checks"
