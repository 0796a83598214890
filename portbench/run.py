"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, limits,
per-layer readers and kernel work counts are the files under `portbench/`
that `BENCHMARK.json` names; `harness/cell.py` says what a run does.
"""

import time

T_START = time.perf_counter()   # the set-up clock starts before any import

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]   # the harness, the program

from harness import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main(sys.argv[1:], T_START))
