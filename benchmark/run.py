"""Run one cell of the benchmark of uvaia_tpu_torch once:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

(harness.py says what a run does).  Exit 0 with one JSON line as the
last line of standard output; any other exit prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the program stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ.pop("UVAIA_TPU_PROFILE", None)
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
