"""The Husky+Panda cell with an obstacle in reach: its env-collision rows
bind, and the check catches a program that gets the obstacle wrong (CPU,
plain routes, tiny batch, every lane checked).

* obstacle ignored: the program ticks with the obstacle out of reach;
* world frame: the program feeds the env network the world obstacle, with
  no transform into the moving base's frame (nor its chain rule).
"""

import time
from unittest import mock

import pytest
import torch

from conftest import tiny
from harness import cell as harness_cell
from harness import sides, spec

WORKLOAD = "husky_panda.fleet-rti-obs-b16384"


class ObstacleIgnored(sides.Program):
    """The program with the fleet's obstacle moved out of reach."""

    def tick(self, carry, x, u, obs_pos, obs_radius, timer=None):
        return super().tick(carry, x, u, torch.full_like(obs_pos, 3.0),
                            torch.zeros_like(obs_radius), timer)


class _WorldFrameKinematics:
    """`models/kinematics_mobile` with the base at the world's origin in
    `_base_transform`, the one function of it `ocp/robot_data.py` calls
    for the env network's input and its base columns."""

    def __init__(self, kinm):
        self._kinm = kinm

    def __getattr__(self, name):
        return getattr(self._kinm, name)

    def _base_transform(self, q_base):
        rb, pb = self._kinm._base_transform(q_base)
        eye = torch.eye(3, dtype=rb.dtype, device=rb.device)
        return eye.expand_as(rb), torch.zeros_like(pb)


class WorldFrame(sides.Program):
    """The program with the obstacle left in the world frame."""

    def tick(self, carry, x, u, obs_pos, obs_radius, timer=None):
        from mpcc_manipulator_tpu_torch.ocp import robot_data
        with mock.patch.object(robot_data, "kinm",
                               _WorldFrameKinematics(robot_data.kinm)):
            return super().tick(carry, x, u, obs_pos, obs_radius, timer)


@pytest.mark.parametrize("fault", [ObstacleIgnored, WorldFrame],
                         ids=["obstacle_ignored", "world_frame"])
def test_obstacle_fault_fails_the_check(fault):
    cell = tiny(spec.Cell(WORKLOAD))
    result, _ = harness_cell.run_cell(cell, 2 ** 31 + 777, 0.5, False,
                                      time.perf_counter(), device="cpu",
                                      make_side=fault)
    assert result["correct"] is False, result["check"]


def test_env_rows_bind_on_half_the_lane_ticks():
    """The tiny cell's first 3 ticks: binding env rows (the program's
    ``env_rows_active`` counter) on at least half of the lane-ticks."""
    from mpcc_manipulator_tpu_torch.solver.sqp_debug import PhaseTimer
    torch.set_num_threads(1)
    cell = tiny(spec.Cell(WORKLOAD))
    side = sides.Program(cell.config, cell.traffic, "cpu")
    x, u, obs_pos, obs_radius = harness_cell.fleet(side, cell.config,
                                                   cell.traffic, 2 ** 31 + 5)
    carry = side.init(cell.traffic["batch"])
    timer = PhaseTimer("cpu", count_ops=True)
    for _ in range(3):
        carry, out = side.tick(carry, x, u, obs_pos, obs_radius, timer=timer)
        x, u = side.plant(out.x0_updated, out.u0), out.u0
        assert bool(out.ok.all())
    got = timer.counter("env_rows_active")
    assert got["ticks"] == 3
    assert got["lane_ticks"] == 3 * cell.traffic["batch"]
    assert got["share"] >= 0.5, got
