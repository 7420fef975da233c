"""port_bench/calibrate.py for the cells of entries that
lib/calibration.py's CONTROLS does not name (the Moonlight cell's
`llm_enrich_moe`), with the controls of their entries:

    python3 port_bench/calibrate_moe.py --workload moonlight-enrich --seeds 1 2 3 ... [--control]

Arguments and output as calibrate.py's; "int4_activations" is the LLM
cells' control (the reference with int4 decode activations).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from port_bench import calibrate  # noqa: E402
from port_bench.lib import calibration  # noqa: E402

CONTROLS = {"llm_enrich_moe": ("int4_activations",)}

if __name__ == "__main__":
    calibration.CONTROLS.update(CONTROLS)
    sys.exit(calibrate.main())
