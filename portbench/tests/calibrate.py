"""The readings the limits of `limits/<workload>.json` are set from, on
the card at the cell's own size: the numbers `correct` compares, for the
program over many seeds and for the control (`tests/sides.control`) over
a few, each run with a short window, all in one process.

    python3 portbench/tests/calibrate.py --workload <name> \
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 3 [--out file.jsonl]

Prints one JSON line a run: kind, seed, every number `check.py`
computes, and the window's work.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE),
                os.path.dirname(os.path.dirname(HERE))]

from harness import cell, check, spec  # noqa: E402
import sides as test_sides  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    a = p.parse_args()
    c = spec.Cell(a.workload)
    c.limits = {k: float("inf") for k in check.NUMBERS}  # read them all
    ints = lambda s: [int(v) for v in s.split(",") if v]
    runs = ([("program", s, None) for s in ints(a.seeds)]
            + [("control", s, test_sides.control)
               for s in ints(a.control_seeds)])
    out = open(a.out, "a") if a.out else None
    for kind, seed, make in runs:
        t0 = time.perf_counter()
        res, log = cell.run_cell(c, seed, a.seconds, False, t0,
                                 make_side=make)
        line = json.dumps(dict(
            workload=a.workload, kind=kind, seed=seed,
            numbers={k: v["value"] for k, v in res["check"].items()},
            attempted=res["attempted"], failed=res["failed"],
            metrics={k: v["value"] for k, v in res["metrics"].items()},
            card=res["card"], seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
