"""The check catches a broken timed path: each fault the cells can have,
planted in the program, makes ``correct`` come out false (CPU, plain
routes, tiny batch, every lane checked)."""

import time

import pytest

import sides
from conftest import tiny
from harness import cell as harness_cell
from harness import spec

WORKLOADS = [w["name"] for w in spec.manifest()["workloads"]]


@pytest.mark.parametrize("fault", sides.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_fails_the_check(workload, fault):
    cell = tiny(spec.Cell(workload))
    result, _ = harness_cell.run_cell(cell, 31337, 0.5, False,
                                      time.perf_counter(), device="cpu",
                                      make_side=sides.faulty(fault))
    assert result["correct"] is False, result["check"]
