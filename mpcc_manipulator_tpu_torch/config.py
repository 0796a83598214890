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

# the dense decision vector z = [x_0 .. x_N, u_0 .. u_{N-1}] and its rows
N_VAR = PANDA.n_var        # 179
N_EQ = PANDA.n_eq          # x_0 pinned + N dynamics defects
N_INEQB = PANDA.n_ineqb    # state boxes + input boxes + ddq rate rows
N_INEQP = PANDA.n_ineqp    # polytopic rows
N_CONSTR = PANDA.n_constr  # 479


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
