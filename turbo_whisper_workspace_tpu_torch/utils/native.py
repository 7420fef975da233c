"""Build-and-load for the in-repo C++ native components (the audio
decoders of native/*.cpp), compiled on first use with the system
toolchain and loaded via ctypes. No pip/apt involved.

Port of turbo_whisper_workspace_tpu/utils/native.py, with two
differences. The libraries go to `build/torch_native/` at the repo root,
never to the JAX loader's `native/build/`, so the two packages share no
output file. And a build is safe across processes (pytest-xdist workers
import the decoders at once): the stale check and the compile run under
an `fcntl.flock` on a lock file beside the output, and the compiler
writes a per-process temporary name that `os.replace` moves into place,
so no process can `dlopen` a half-written library. `ops/build.py` builds
the CUDA kernels the same way, through `locked` and `temp_path`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_SRC = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


@contextlib.contextmanager
def locked(path: str):
    """Hold an exclusive `flock` on `path` (created if missing) across
    processes; the kernel drops it if the holder dies."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def temp_path(path: str) -> str:
    """A name beside `path` that only this process writes."""
    return f"{path}.{os.getpid()}.tmp"


def load_native(name: str, extra_flags: list[str] | None = None,
                build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Compile native/<name>.cpp into `build_dir` (if stale) and dlopen
    the result."""
    src = os.path.join(_NATIVE_SRC, f"{name}.cpp")
    so = os.path.join(build_dir, f"lib{name}.so")
    with _LOCK:
        if so in _CACHE:
            return _CACHE[so]
        os.makedirs(build_dir, exist_ok=True)
        with locked(so + ".lock"):
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                tmp = temp_path(so)
                cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                       "-o", tmp, src] + (extra_flags or [])
                logger.info("building native library: %s", " ".join(cmd))
                try:
                    subprocess.run(cmd, check=True, capture_output=True)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
        lib = ctypes.CDLL(so)
        _CACHE[so] = lib
        return lib
