"""A CPU rehearsal of the command: every cell at a tiny batch on the plain
routes, its result line, and what it loads."""

import ast
import glob
import json
import os
import subprocess
import sys
import time

import pytest

from conftest import BENCH as BENCH_DIR, ROOT, tiny
from harness import cell as harness_cell
from harness import spec

WORKLOADS = [w["name"] for w in spec.manifest()["workloads"]]
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [0, 1], ids=["window", "traced"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(workload, trace):
    cell = tiny(spec.Cell(workload))
    result, log = harness_cell.run_cell(cell, 2 ** 31 + 12345, 1.0,
                                        bool(trace), time.perf_counter(),
                                        device="cpu")
    assert REQUIRED <= set(result)
    assert set(result) - REQUIRED <= {"breakdown", "card", "check"}
    assert list(result)[-1] == "check"
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    json.dumps(result)


def test_command_refuses_without_card():
    """No card: a code other than 0 and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_loads_no_jax():
    """A whole run loads no module named jax, jaxlib, flax or
    mpcc_manipulator_tpu (top-level names compared whole)."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import tiny\n"
        "from harness import cell, spec\n"
        "c = tiny(spec.Cell(%r))\n"
        "cell.run_cell(c, 7, 0.5, True, time.perf_counter(), device='cpu')\n"
        "print(cell.forbidden_modules())\n"
        "print('mpcc_manipulator_tpu_torch' in sys.modules)\n"
    ) % (os.path.join(BENCH_DIR, "tests"), BENCH_DIR, ROOT, WORKLOADS[0])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[-3:-1] == ["[]", "True"]


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(BENCH_DIR, "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_sources_import_no_jax(path):
    found = _imports(path)
    assert not found & set(harness_cell.FORBIDDEN)
    if "/refmpcc/" in path:   # the reference takes nothing of the program
        assert harness_cell.PROGRAM not in found
