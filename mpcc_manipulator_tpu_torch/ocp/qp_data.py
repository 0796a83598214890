"""Decision-vector helpers and the line search's value-only evaluations,
batch-first (`mpcc_manipulator_tpu/ocp/qp_data.py`).

``z = [x_0..x_N, u_0..u_{N-1}]`` per scenario (n_var = 179 for the Panda);
the constraint rows are ``[equality | bounds | polytopic]`` as in the
reference layout.  The dense QP assembly (``build_qp``) belongs to the
dense ADMM path (ROADMAP item 14) and is not ported.
"""

from __future__ import annotations

import torch

from ..params import MPCCParams
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from .constraints import stage_constraints, state_bounds
from .cost import stage_cost
from .robot_data import RobotData


def split_z(z: torch.Tensor, system: System = PANDA):
    """z (B, n_var) -> xs (B, N+1, nx), us (B, N, nu)."""
    nx, nu, n = system.nx, system.nu, system.horizon
    b = z.shape[0]
    return (z[:, :nx * (n + 1)].reshape(b, n + 1, nx),
            z[:, nx * (n + 1):].reshape(b, n, nu))


def join_z(xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    b = xs.shape[0]
    return torch.cat([xs.reshape(b, -1), us.reshape(b, -1)], dim=-1)


def us_padded(us: torch.Tensor) -> torch.Tensor:
    """(B, N+1, nu) inputs with a zero terminal input."""
    return torch.cat([us, torch.zeros_like(us[:, :1])], dim=1)


def _is_terminal(n: int, device=None) -> torch.Tensor:
    """Per-knot terminal mask for an ``n``-stage horizon."""
    return torch.arange(n + 1, device=device) == n


def _discrete_ab(ts, dtype, device, system: System = PANDA):
    from ..models.dynamics import discrete_ab
    ad, bd, _ = discrete_ab(float(ts), system)
    return (torch.tensor(ad, dtype=dtype, device=device),
            torch.tensor(bd, dtype=dtype, device=device))


def total_objective(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                    params: MPCCParams, exact_heading_jac: bool = False,
                    system: System = PANDA) -> torch.Tensor:
    """(B,) objective including the ddq smoothness term."""
    xs, us = split_z(z, system)
    objs = stage_cost(track, xs, us_padded(us), rb,
                      _is_terminal(system.horizon, z.device), params,
                      exact_heading_jac, with_derivatives=False,
                      system=system)
    ddq = us[:, 1:, :system.dof] - us[:, :-1, :system.dof]
    return objs.sum(-1) + params.cost.r_ddq * (ddq * ddq).sum((-1, -2))


def constraint_values(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                      params: MPCCParams, current_u: torch.Tensor, ts,
                      system: System = PANDA):
    """(constr, l, u), each (B, n_constr), value-only."""
    dtype, dev = z.dtype, z.device
    dof, nx, nu, n = system.dof, system.nx, system.nu, system.horizon
    b = z.shape[0]
    xs, us = split_z(z, system)

    # equality: defect T_x_inv (x_i - (Ad x_{i-1} + Bd u_{i-1})); row 0 = 0
    ad, bd = _discrete_ab(ts, dtype, dev, system)
    pred = xs[:, :-1] @ ad.T + us @ bd.T
    defect = (xs[:, 1:] - pred) * params.normalization.t_x_inv
    c_eq = torch.cat([z.new_zeros(b, nx), defect.reshape(b, -1)], dim=-1)
    z_eq = z.new_zeros(b, system.n_eq)

    # bound rows: raw states / inputs / rates
    bx_l, bx_u = state_bounds(xs, params, track.length, system)
    rate = torch.cat([us[:, :1, :dof] / ts,
                      (us[:, 1:, :dof] - us[:, :-1, :dof]) / ts], dim=1)
    c_rate = torch.cat([rate, z.new_zeros(b, n, nu - dof)], -1).reshape(b, -1)
    bp = params.bounds
    zpad = z.new_zeros(nu - dof)
    ddq_l0 = bp.ddq_l + current_u[:, :dof] / ts
    ddq_u0 = bp.ddq_u + current_u[:, :dof] / ts
    rep = lambda v: torch.cat([v, zpad]).repeat(n - 1).expand(b, -1)
    l_rate = torch.cat([ddq_l0, zpad.expand(b, -1), rep(bp.ddq_l)], -1)
    u_rate = torch.cat([ddq_u0, zpad.expand(b, -1), rep(bp.ddq_u)], -1)
    c_ineqb = torch.cat([xs.reshape(b, -1), us.reshape(b, -1), c_rate], -1)
    l_ineqb = torch.cat([bx_l.reshape(b, -1),
                         bp.u_l.repeat(n).expand(b, -1), l_rate], -1)
    u_ineqb = torch.cat([bx_u.reshape(b, -1),
                         bp.u_u.repeat(n).expand(b, -1), u_rate], -1)

    cp, cpl, cpu = stage_constraints(xs, us_padded(us), rb,
                                     _is_terminal(n, dev), params,
                                     with_jacobian=False, system=system)
    constr = torch.cat([c_eq, c_ineqb, cp.reshape(b, -1)], -1)
    lvec = torch.cat([z_eq, l_ineqb, cpl.reshape(b, -1)], -1)
    uvec = torch.cat([z_eq, u_ineqb, cpu.reshape(b, -1)], -1)
    return constr, lvec, uvec


def constraint_norm(constr, l, u):
    """Per-lane l1 violation of ``l <= c <= u``."""
    return (torch.clamp(l - constr, min=0.0).sum(-1)
            + torch.clamp(constr - u, min=0.0).sum(-1))


def denormalize_step(step: torch.Tensor, params: MPCCParams,
                     system: System = PANDA) -> torch.Tensor:
    """Normalized QP step (B, n_var) -> raw decision-space step."""
    sx, su = split_z(step, system)
    return join_z(sx * params.normalization.t_x,
                  su * params.normalization.t_u)
