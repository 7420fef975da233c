"""Port native-library build (turbo_whisper_workspace_tpu_torch/utils/
native.py): builds are safe across processes. Four processes load one
native source at once into an empty build directory: each gets a library
that loads and has its entry points, and no temporary file is left
behind. The port builds into its own directory,
never the JAX loader's."""

import multiprocessing
import os

from turbo_whisper_workspace_tpu_torch.utils import native


def _load(build_dir: str) -> str:
    lib = native.load_native("flac_decoder", build_dir=build_dir)
    return "ok" if hasattr(lib, "flac_decode") and hasattr(lib, "flac_stream_info") else "bad"


def test_four_processes_build_one_library(tmp_path):
    build_dir = str(tmp_path / "build")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        results = [pool.apply_async(_load, (build_dir,)) for _ in range(4)]
        got = [r.get(timeout=300) for r in results]
    assert got == ["ok"] * 4
    assert sorted(os.listdir(build_dir)) == ["libflac_decoder.so", "libflac_decoder.so.lock"]


def test_build_dir_is_the_ports_own():
    assert native.BUILD_DIR.endswith(os.path.join("build", "torch_native"))
    assert os.path.join("native", "build") not in native.BUILD_DIR


def test_temp_path_is_per_process():
    assert native.temp_path("/x/lib.so") == f"/x/lib.so.{os.getpid()}.tmp"
