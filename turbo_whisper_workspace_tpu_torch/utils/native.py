"""Port copy of turbo_whisper_workspace_tpu/utils/native.py: the same
native/ sources and build cache, resolved from this package's root.

Build-and-load for the in-repo C++ native components.

The reference depends on prebuilt third-party native engines (sherpa-onnx,
llama.cpp, ffmpeg — SURVEY.md §2.3). Our native code lives in native/*.cpp
and is compiled on first use with the system toolchain into a per-repo
cache, then loaded via ctypes. No pip/apt involved.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_SRC = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


def load_native(name: str, extra_flags: list[str] | None = None) -> ctypes.CDLL:
    """Compile native/<name>.cpp (if stale) and dlopen the result."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(_NATIVE_SRC, f"{name}.cpp")
        so = os.path.join(_BUILD_DIR, f"lib{name}.so")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   "-o", so, src] + (extra_flags or [])
            logger.info("building native library: %s", " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        _CACHE[name] = lib
        return lib
