"""The benchmark's manifest and the files it names.

`BENCHMARK.json` sits at the root of the checkout, one directory above
`portbench/`.  Every piece of one cell is a file of its own, found by name:

* ``configs/<config>.json``: the configuration (its ``file`` entry);
* ``traffic/<traffic>.json``: the traffic mix, the parameters the one
  generator (`harness/cell.py`) reads;
* ``limits/<workload>.json``: the limits of the numbers `correct` compares;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``kernels/*.py``: one kernel's work count each (all of them are read).
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names, resolved."""

    def __init__(self, workload: str, bench: dict | None = None):
        bench = bench or manifest()
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the manifest "
                             f"has {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(ROOT, self.config_entry["file"])
        self.traffic = _json(HERE, "traffic", f"{self.entry['traffic']}.json")
        self.limits = _json(HERE, "limits", f"{workload}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """The ``read(ctx)`` of a per-layer metric (`metrics/<metric>.py`)."""
    return _module(os.path.join(HERE, "metrics", f"{metric}.py"),
                   f"portbench_metric_{metric.replace('.', '_')}").read


def kernels() -> list:
    """Every kernel's work count (`kernels/*.py`), as modules."""
    return [_module(p, f"portbench_kernel_{os.path.basename(p)[:-3]}")
            for p in sorted(glob.glob(os.path.join(HERE, "kernels", "*.py")))]
