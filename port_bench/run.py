"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
Prints the run's result as one JSON object, the last line of standard
output (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, then the numbers the check compared,
`checks`), and the same checks as the last lines of standard error. The
cells, configurations and metrics are named in BENCHMARK.json; see
port_bench/lib/bench.py for what a run does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches live at fixed paths inside the checkout, so
# only a checkout's first run builds (ops/build.py: build/torch_cuda)
CACHES = {"TRITON_CACHE_DIR": "build/triton_cache",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor_cache"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = os.path.join(ROOT, rel)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # the root, not this folder, on the path: the harness is the package port_bench
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") !=
                            os.path.dirname(os.path.abspath(__file__))]
    from port_bench.lib import bench

    return bench.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          T_START)


if __name__ == "__main__":
    sys.exit(main())
