"""The JAX package's obstacle gates (`tests/test_obstacle_avoidance.py`,
`tests/test_rti.py:109`) held for the port, float64 on the CPU, through
the runners of `mpcc_manipulator_tpu_torch/gates.py` (one lane from the
exact home state; the card runs the same runners on 8 lanes in float32).

The solver is the port's structured interior-point route (JAX's gates run
`qp_solver="riccati"`, the packed solver the port leaves out; the port's
structured IPM is the same algorithm as JAX's `riccati_struct`): converged
`SQPConfig(rti=False, max_iter=20, ipm_max_iter=25)`, RTI
`SQPConfig(max_iter=1, rti=True, ipm_max_iter=25)`.  The thresholds and the
`slow` markings are JAX's.
"""

import pytest
import torch

from mpcc_manipulator_tpu_torch import gates

torch.set_num_threads(1)

DT = torch.float64


def test_static_obstacle_margin_held_and_constraint_bites():
    """300 ticks constrained: the margin (11.6 cm - 1 cm), the CBF rate
    contract (-0.05 cm), progress past 0.2 L and a stop short of the
    sphere, the self-collision margin; 300 ticks with the constraint
    disabled drive through the sphere (s past it, the margin broken by more
    than 3 cm)."""
    r = gates.static_obstacle(DT, "cpu", lanes=1)
    assert r["worst_env_min_cm"] >= gates.MARGIN - gates.EPS_CM
    assert r["worst_cbf_cm"] >= -gates.CBF_EPS_CM


@pytest.mark.slow
def test_static_detour_obstacle_avoided_with_progress():
    gates.detour_obstacle(DT, "cpu", lanes=1)


@pytest.mark.slow
def test_oscillating_obstacle_passed_with_margin():
    gates.oscillating_obstacle(DT, "cpu", lanes=1)


@pytest.mark.slow
def test_rti_obstacle_margin_held():
    gates.rti_obstacle(DT, "cpu", lanes=1)
