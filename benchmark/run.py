"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel and compiler caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
# few host threads: the from-host cell's rate spreads least with four
os.environ["OMP_NUM_THREADS"] = "4"
# the checkout root, not this directory, is where imports start
sys.path[0] = str(ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_START))
