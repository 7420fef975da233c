"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source has a plain C interface and becomes its own shared library,
compiled by `nvcc` for `sm_90a` into `build/torch_cuda/` at the repo
root (ignored by git) and loaded with ctypes. All stale sources compile
at once, one `nvcc` process each. A library is rebuilt when its source,
or a header in csrc/ (the sources' shared helpers), is newer. Nothing
here runs at import time: the CPU tests import every module on machines
with no `nvcc`.

No JAX counterpart: the JAX package's Pallas kernels are compiled by
`jax.jit` at their call sites (turbo_whisper_workspace_tpu/ops/attention.py,
turbo_whisper_workspace_tpu/ops/quant.py).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# kernel name → its C entry point's argument types (pointers and the
# stream as c_void_p, so ctypes never narrows them to 32 bits)
SIGNATURES = {
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _P],
    "cross_attention_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cross_attention_s8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "self_attention_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "self_attention_int8_lanes": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    "int4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "int4_matmul_s8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "s8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "s8g4_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name → nvcc's output (register and shared-memory use, from -Xptxas -v)
build_log: dict[str, str] = {}


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build_all() -> float:
    """Compile every stale kernel library in parallel; returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        headers = [os.path.getmtime(h) for h in glob.glob(os.path.join(_CSRC, "*.cuh"))]
        procs = {}
        for name in SIGNATURES:
            src, so = source_path(name), os.path.join(_BUILD_DIR, f"lib{name}.so")
            if os.path.exists(so) and os.path.getmtime(so) >= max(
                    [os.path.getmtime(src), *headers]):
                continue
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", so, src]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(path: str, name: str) -> ctypes.CDLL:
    """The library at `path` holding kernel `name`'s C entry points, with
    their argument and result types set."""
    lib = ctypes.CDLL(path)
    entry = getattr(lib, f"tww_{name}")
    entry.argtypes = SIGNATURES[name]
    entry.restype = ctypes.c_int
    err = getattr(lib, f"tww_{name}_error")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = load(os.path.join(_BUILD_DIR, f"lib{name}.so"), name)
        return _LIBS[name]


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point; raise if the launch failed."""
    lib = library(name)
    code = getattr(lib, f"tww_{name}")(*args)
    if code != 0:
        msg = getattr(lib, f"tww_{name}_error")(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
