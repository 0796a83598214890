"""Static problem dimensions and index maps (`mpcc_manipulator_tpu/config.py`).

State ``x = [q1..q7, s, vs]``, input ``u = [dq1..dq7, dVs]`` for the
fixed-base Franka Panda at N = 10; all shapes are fixed Python integers.
The dims below are the reference's surface, read off ``system.PANDA``: the
port's modules take their shapes from a :class:`~.system.System`.
"""

from __future__ import annotations

from .system import INF, N_SPLINE, PANDA  # noqa: F401  (re-exported)

PANDA_DOF = PANDA.arm_dof          # number of revolute joints
PANDA_NUM_LINKS = PANDA.num_links  # link0..link7 + hand (env collision)

NX = PANDA.nx          # state dim:  [q(7), s, vs]
NU = PANDA.nu          # input dim:  [dq(7), dVs]
NPC = PANDA.npc        # polytopic rows a knot: self-, singularity, 9x env
N = PANDA.horizon      # horizon length (knots 0..N)


class ConstraintIndex:
    """Row index of each polytopic constraint inside an ``(NPC,)`` block."""
    con_selcol = 0
    con_sing = 1
    con_envcol1 = 2   # env collision rows 2..10 (link0..link7, hand)
