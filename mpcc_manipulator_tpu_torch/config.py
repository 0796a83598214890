"""Static problem dimensions and index maps (`mpcc_manipulator_tpu/config.py`).

State ``x = [q1..q7, s, vs]``, input ``u = [dq1..dq7, dVs]`` for the
fixed-base Franka Panda; all shapes are fixed Python integers.
"""

from __future__ import annotations

PANDA_DOF = 7          # number of revolute joints
PANDA_NUM_LINKS = 9    # link0..link7 + hand frames tracked for env collision

N_SPLINE = 100         # arc-length spline resampling points
INF = 1e30             # "infinity" used in constraint bounds (matches reference)


class ConstraintIndex:
    """Row index of each polytopic constraint inside an ``(NPC,)`` block."""
    con_selcol = 0
    con_sing = 1
    con_envcol1 = 2   # env collision rows 2..10 (link0..link7, hand)
