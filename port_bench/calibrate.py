"""The readings a cell's correctness limit is set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control]

For each seed: the cell's set-up, then a short window of `--calls`
calls of its traffic at its own load, then the cell's check; prints one
JSON line per seed with the numbers compared and the verdict a run would
give (`correct`). These are the lower readings: sound runs of the
program. With --control the same calls are judged again with something
else in the program's place, each read through the same check and
verdict (each must come out not correct):

* ASR cells: "fp8", the reference with every product's operands in
  float8 (one step below the configured bf16), read at every position of
  the same prompts and tokens as the token it puts first and its mean
  log-probability of the served tokens; "second_best", the fault of a
  wrong argmax: the reference's second-best token under the grammar at
  each position, reported with its own log-probability;
* the LLM cell: "int4_activations", the reference with int4 decode
  activations (one step below the configured W4A8), read the same way.

The benchmark's own runs never run this. Its sizes are the cell's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--calls", type=int, default=0,
                        help="calls a seed's window makes (0: the whole pool once)")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json to read")
    parser.add_argument("--data-dir", default=None)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") !=
                            os.path.dirname(os.path.abspath(__file__))]
    from port_bench.lib import calibration

    for seed in args.seeds:
        out = calibration.readings(args.root, args.workload, seed, args.calls, args.control,
                                   args.device, args.data_dir)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
