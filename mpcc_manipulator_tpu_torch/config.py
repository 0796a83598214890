"""Static problem dimensions and index maps (`mpcc_manipulator_tpu/config.py`).

State ``x = [q1..q7, s, vs]``, input ``u = [dq1..dq7, dVs]`` for the
fixed-base Franka Panda; all shapes are fixed Python integers.
"""

from __future__ import annotations

from .system import PANDA

PANDA_DOF = 7          # number of revolute joints
PANDA_NUM_LINKS = 9    # link0..link7 + hand frames tracked for env collision

N_SPLINE = 100         # arc-length spline resampling points
INF = 1e30             # "infinity" used in constraint bounds (matches reference)

class StateIndex:
    """Index of each state component inside an ``(nx,)`` vector."""
    q1, q2, q3, q4, q5, q6, q7 = range(PANDA_DOF)
    s = 7
    vs = 8


class InputIndex:
    """Index of each input component inside an ``(nu,)`` vector."""
    dq1, dq2, dq3, dq4, dq5, dq6, dq7 = range(PANDA_DOF)
    dVs = 7


class ConstraintIndex:
    """Row index of each polytopic constraint inside an ``(NPC,)`` block."""
    con_selcol = 0
    con_sing = 1
    con_envcol1 = 2   # env collision rows 2..10 (link0..link7, hand)


def state_offset(k: int) -> int:
    """Offset of state ``x_k`` inside the stacked decision vector
    ``z = [x_0 .. x_N, u_0 .. u_{N-1}]`` (the Panda at N = 10)."""
    return PANDA.nx * k


def input_offset(k: int) -> int:
    """Offset of input ``u_k`` inside the stacked decision vector."""
    return PANDA.nx * (PANDA.horizon + 1) + PANDA.nu * k
