"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Module names are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench.lib import bench, spec

ROOT = os.path.dirname(spec.BENCH_DIR)
JAX_SIDE = bench.FORBIDDEN
PORT = "turbo_whisper_workspace_tpu_torch"


def top_names(path: str) -> set[str]:
    """Top-level names of every module the file imports."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(spec.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_whole_names_tell_the_port_from_the_jax_package():
    assert PORT.split(".")[0] not in JAX_SIDE
    assert "turbo_whisper_workspace_tpu" in JAX_SIDE
    assert PORT.startswith("turbo_whisper_workspace_tpu")        # why a prefix test is wrong


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not top_names(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_the_reference_imports_nothing_of_the_port(path):
    names = top_names(path)
    assert PORT not in names and not names & JAX_SIDE


def test_the_reference_loads_nothing_of_the_port_when_run():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.whisper, port_bench.reference.llama\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & %r)\n"
            "print(bad)" % (ROOT, JAX_SIDE | {PORT}))
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The harness, every entry and metric, and the port modules the
    entries drive, imported in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench.lib import bench, spec, asr, calibration\n"
        "for e in ('asr_batch', 'asr_request', 'llm_enrich'): spec.entry(e)\n"
        "import glob, os\n"
        "for f in glob.glob(os.path.join(spec.BENCH_DIR, 'metrics', '*.py')):\n"
        "    spec.metric(os.path.basename(f)[:-3])\n"
        "from turbo_whisper_workspace_tpu_torch.pipeline import transcriber, audio_pipeline\n"
        "from turbo_whisper_workspace_tpu_torch.llm import llm_helper, generate\n"
        "from turbo_whisper_workspace_tpu_torch.ops import build, quant, attention\n"
        "from turbo_whisper_workspace_tpu_torch.utils import step_loop\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (ROOT, JAX_SIDE))
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
