"""The port imports neither `jax` nor the JAX package, nor scikit-learn.

The pytest process itself has jax loaded (tests/conftest.py), so the
import check runs in a fresh isolated interpreter; the source check
walks every module of the port, and chip_smoke.py, for import
statements."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "turbo_whisper_workspace_tpu_torch"
# sklearn: the GPU machine the port runs on has no scikit-learn, so an
# import of it there is a fault that only the card would show (the CPU
# test machine has it); the diarizer clusters on scipy instead
FORBIDDEN = ("jax", "turbo_whisper_workspace_tpu", "sklearn")


def _is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


# the modules of the offline tool shell, listed so that a missing file
# fails here instead of dropping out of the glob
TOOL_SHELL = [
    "turbo_whisper_workspace_tpu_torch.analysis",
    "turbo_whisper_workspace_tpu_torch.analysis.audio_info",
    "turbo_whisper_workspace_tpu_torch.analysis.bar_security_monitor",
    "turbo_whisper_workspace_tpu_torch.analysis.diagnostics",
    "turbo_whisper_workspace_tpu_torch.analysis.preprocess",
    "turbo_whisper_workspace_tpu_torch.analysis.security_monitor",
    "turbo_whisper_workspace_tpu_torch.analysis.visualizer",
    "turbo_whisper_workspace_tpu_torch.audio.features",
    "turbo_whisper_workspace_tpu_torch.utils.evaluate",
    "turbo_whisper_workspace_tpu_torch.utils.profiling",
]


# serving and parallelism, likewise
SERVE_AND_PARALLEL = [
    "turbo_whisper_workspace_tpu_torch.parallel",
    "turbo_whisper_workspace_tpu_torch.parallel.batch_driver",
    "turbo_whisper_workspace_tpu_torch.parallel.infer",
    "turbo_whisper_workspace_tpu_torch.parallel.mesh",
    "turbo_whisper_workspace_tpu_torch.parallel.sharding",
    "turbo_whisper_workspace_tpu_torch.parallel.train",
    "turbo_whisper_workspace_tpu_torch.serve",
    "turbo_whisper_workspace_tpu_torch.serve.api",
    "turbo_whisper_workspace_tpu_torch.serve.client",
    "turbo_whisper_workspace_tpu_torch.serve.ui",
]


def test_tool_shell_modules_are_checked():
    assert set(TOOL_SHELL) <= set(_port_modules())


def test_serve_and_parallel_modules_are_checked():
    assert set(SERVE_AND_PARALLEL) <= set(_port_modules())


def test_port_imports_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        + "".join(f"import {m}\n" for m in _port_modules())
        + f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.')"
        f" for f in {FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_worker.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
