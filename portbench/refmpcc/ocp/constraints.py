"""Polytopic constraints (RBF-softened barrier rows) and box bounds,
batched over leading axes (`mpcc_manipulator_tpu/ocp/constraints.py`).

Per knot the NPC = 11 rows are, in order: self-collision, singularity, and
9 env-collision rows, each ``-d_h(q)' dq + RBF(h(q)) <= 0`` with the relaxed
log barrier (delta = -0.5) and NN distances converted cm -> m; all rows are
zeroed at the terminal knot.
"""

from __future__ import annotations

import math

import torch

from ..config import INF, ConstraintIndex
from ..params import MPCCParams
from ..system import PANDA, System
from .robot_data import RobotData

RBF_DELTA = -0.5


def rbf(h, delta=RBF_DELTA):
    """Relaxed barrier: -log(h+1) above delta, quadratic extension below."""
    above = -torch.log(torch.clamp(h, min=delta) + 1.0)
    below = (-math.log(delta + 1.0) - (h - delta) / (delta + 1.0)
             + (h - delta) ** 2 / (2.0 * (delta + 1.0) ** 2))
    return torch.where(h >= delta, above, below)


def drbf(h, delta=RBF_DELTA):
    """Derivative of :func:`rbf`."""
    above = -1.0 / (torch.clamp(h, min=delta) + 1.0)
    below = -1.0 / (delta + 1.0) + (h - delta) / (delta + 1.0) ** 2
    return torch.where(h >= delta, above, below)


def stage_constraints(x: torch.Tensor, u: torch.Tensor, rb: RobotData,
                      is_terminal: torch.Tensor, params: MPCCParams,
                      with_jacobian: bool = True, system: System = PANDA):
    """All NPC rows at every knot.

    Returns ``(c, c_l, c_u)`` or ``(c, c_l, c_u, c_x (...,NPC,NX),
    c_u_jac (...,NPC,NU))``.
    """
    dof = system.dof
    dq = u[..., :dof]
    m = params.model
    not_term = torch.where(is_terminal, 0.0, 1.0).to(x.dtype)
    not_term = not_term.expand(x.shape[:-1])

    sel_h = 0.01 * rb.sel_dist - 0.01 * m.tol_selcol
    d_sel = 0.01 * rb.d_sel_dist
    c_sel = not_term * (-(d_sel * dq).sum(-1) + rbf(sel_h))

    sing_h = rb.manipul - m.tol_sing
    d_sing = rb.d_manipul
    c_sing = not_term * (-(d_sing * dq).sum(-1) + rbf(sing_h))

    env_h = (0.01 * (rb.env_dist - 1.2 * rb.obs_radius[..., None])
             - 0.01 * m.tol_envcol)
    d_env = 0.01 * rb.d_env_dist
    c_env = not_term[..., None] * (-(d_env @ dq[..., None])[..., 0]
                                   + rbf(env_h))

    c = torch.cat([c_sel[..., None], c_sing[..., None], c_env], dim=-1)
    c_l = torch.where((not_term > 0)[..., None], x.new_full((), -INF),
                      x.new_zeros(())).expand(c.shape)
    c_u = torch.zeros_like(c)
    if not with_jacobian:
        return c, c_l, c_u

    c_x = x.new_zeros(x.shape[:-1] + (system.npc, system.nx))
    c_x[..., ConstraintIndex.con_selcol, :dof] = (
        not_term * drbf(sel_h))[..., None] * d_sel
    c_x[..., ConstraintIndex.con_sing, :dof] = (
        not_term * drbf(sing_h))[..., None] * d_sing
    c_x[..., ConstraintIndex.con_envcol1:, :dof] = (
        not_term[..., None] * drbf(env_h))[..., None] * d_env

    c_u_jac = x.new_zeros(x.shape[:-1] + (system.npc, system.nu))
    c_u_jac[..., ConstraintIndex.con_selcol, :dof] = not_term[..., None] * -d_sel
    c_u_jac[..., ConstraintIndex.con_sing, :dof] = not_term[..., None] * -d_sing
    c_u_jac[..., ConstraintIndex.con_envcol1:, :dof] = (
        not_term[..., None, None] * -d_env)
    return c, c_l, c_u, c_x, c_u_jac


def state_bounds(x: torch.Tensor, params: MPCCParams, track_length,
                 system: System = PANDA):
    """Per-knot state box with the s trust region:
    s in [max(s_k - tr, 0), min(s_k + tr, L)]."""
    b = params.bounds
    s = x[..., system.s_idx]
    lo = b.x_l.expand(x.shape).clone()
    hi = b.x_u.expand(x.shape).clone()
    lo[..., system.s_idx] = torch.clamp(s - params.model.s_trust_region,
                                        min=0.0)
    hi[..., system.s_idx] = torch.minimum(s + params.model.s_trust_region,
                                          track_length)
    return lo, hi
