"""System descriptors: the robot platform as a frozen dataclass of integers
(`mpcc_manipulator_tpu/system.py`).

* ``PANDA``: the fixed-base 7-DOF arm (state ``[q(7), s, vs]``, input
  ``[dq(7), dVs]``);
* ``HUSKY_PANDA``: the 10-DOF mobile manipulator, planar virtual base
  joints + arm (state ``[x_b, y_b, th_b, q(7), s, vs]``, input
  ``[dx_b, dy_b, dth_b, dq(7), dVs]``).

``horizon`` is the MPC horizon N, a field like the others:
``dataclasses.replace(PANDA, horizon=20)`` runs the whole tick at N = 20
(the kernels take N at run time).  The dense ADMM QP (``ocp/qp_data.py::
build_qp``) stays at the Panda at N = 10, as in JAX.
"""

from __future__ import annotations

import dataclasses

N = 10
N_SPLINE = 100         # arc-length spline resampling points
INF = 1e30             # "infinity" in constraint bounds (the reference's)


@dataclasses.dataclass(frozen=True)
class System:
    """Static dimensional description of one robot platform."""

    name: str            # "panda" | "husky_panda"
    base_dof: int        # 0 (fixed base) or 3 (planar virtual joints)
    arm_dof: int = 7
    num_links: int = 9   # env-collision distance rows (link0..7 + hand)
    horizon: int = N     # MPC horizon (knots 0..horizon)

    @property
    def dof(self) -> int:
        return self.base_dof + self.arm_dof

    @property
    def nx(self) -> int:
        """State dim: [q(dof), s, vs]."""
        return self.dof + 2

    @property
    def nu(self) -> int:
        """Input dim: [dq(dof), dVs]."""
        return self.dof + 1

    @property
    def npc(self) -> int:
        """Polytopic rows/knot: self-collision, singularity, env rows."""
        return 2 + self.num_links

    @property
    def s_idx(self) -> int:
        return self.dof

    @property
    def vs_idx(self) -> int:
        return self.dof + 1

    @property
    def dvs_idx(self) -> int:
        return self.dof

    @property
    def arm_slice(self) -> slice:
        """Slice of the arm joints inside q / dq vectors."""
        return slice(self.base_dof, self.base_dof + self.arm_dof)

    @property
    def n_var(self) -> int:
        return self.nx * (self.horizon + 1) + self.nu * self.horizon

    @property
    def n_eq(self) -> int:
        return self.nx * (self.horizon + 1)

    @property
    def n_ineqb(self) -> int:
        """Bound rows: state boxes, input boxes, rate rows (nu-strided,
        dof used a knot)."""
        return (self.nx * (self.horizon + 1) + self.nu * self.horizon
                + self.nu * self.horizon)

    @property
    def n_ineqp(self) -> int:
        """Polytopic rows."""
        return self.npc * (self.horizon + 1)

    @property
    def n_constr(self) -> int:
        return self.n_eq + self.n_ineqb + self.n_ineqp

    @property
    def nxt(self) -> int:
        """Augmented stage state x~ = [x; u_prev]."""
        return self.nx + self.nu

    @property
    def nzt(self) -> int:
        return self.nxt + self.nu

    @property
    def nc_stage(self) -> int:
        """Inequality rows per stage: state box x2, input box x2, rate rows
        x2 (all dof inputs), polytopic."""
        return 2 * self.nx + 2 * self.nu + 2 * self.dof + self.npc


PANDA = System(name="panda", base_dof=0)
HUSKY_PANDA = System(name="husky_panda", base_dof=3)

SYSTEMS = {s.name: s for s in (PANDA, HUSKY_PANDA)}
