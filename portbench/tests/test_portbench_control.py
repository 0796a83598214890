"""The control, the reference in float32 with TF32 matmuls in the
program's place, fails the check; the program at the same size passes.
TF32 exists only on the card, so this runs there (a small batch)."""

import time

import pytest

import sides
from harness import cell as harness_cell
from harness import spec

WORKLOADS = [w["name"] for w in spec.manifest()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_program_passes(workload, card):
    def run(make_side):
        cell = spec.Cell(workload)
        cell.traffic = dict(cell.traffic, batch=256, check_lanes=128)
        return harness_cell.run_cell(cell, 424242, 2.0, False,
                                     time.perf_counter(), device=card,
                                     make_side=make_side)[0]
    assert run(None)["correct"] is True
    assert run(sides.control)["correct"] is False
