"""Dense QP assembly, decision-vector helpers and the line search's
value-only evaluations, batch-first (`mpcc_manipulator_tpu/ocp/qp_data.py`).

``z = [x_0..x_N, u_0..u_{N-1}]`` per scenario (n_var = 179 for the Panda);
the constraint rows are ``[equality | bounds | polytopic]`` as in the
reference layout.  :func:`build_qp` assembles the dense normalized QP of
the ADMM path, ``(P (B,179,179), q (B,179), A (B,479,179), l, u (B,479),
obj (B,), constr (B,479))``: every per-knot block comes from one batched
sweep over the horizon and lands in the dense matrices through static
index grids, built once (Panda, N = 10 only, as in the JAX package).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import MPCCParams
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from .constraints import stage_constraints, state_bounds
from .cost import stage_cost
from .robot_data import RobotData


# ------------------------------------------------------------------
# Static index grids of the dense layout (host numpy, built once)
# ------------------------------------------------------------------


def _block_grid(row0, col0, h: int, w: int):
    """(K, h, w) row/col index grids for K dense blocks at given offsets."""
    row0, col0 = np.asarray(row0), np.asarray(col0)
    r = row0[:, None, None] + np.arange(h)[None, :, None]
    c = col0[:, None, None] + np.arange(w)[None, None, :]
    return (np.broadcast_to(r, (len(row0), h, w)),
            np.broadcast_to(c, (len(row0), h, w)))


def _dense_grids(system: System = PANDA):
    """``(P grids, A grids)``: name -> (rows, cols) of every block."""
    nx, nu, dof, npc, n = (system.nx, system.nu, system.dof, system.npc,
                           system.horizon)
    x_off = np.array([nx * k for k in range(n + 1)])
    u_off = np.array([nx * (n + 1) + nu * k for k in range(n)])
    p_grids = dict(
        hxx=_block_grid(x_off, x_off, nx, nx),
        huu=_block_grid(u_off, u_off, nu, nu),
        hxu=_block_grid(x_off[:n], u_off, nx, nu),
        hux=_block_grid(u_off, x_off[:n], nu, nx),
        huu_next=_block_grid(u_off[:n - 1], u_off[1:], nu, nu),
        huu_prev=_block_grid(u_off[1:], u_off[:n - 1], nu, nu))
    # equality rows: row block k couples x_{k-1}, x_k, u_{k-1}
    eq_row = np.array([nx * k for k in range(n + 1)])
    # bound rows.  Deliberate deviation kept from the JAX package: the
    # reference writes the input-box identity into columns nu * i (the
    # state region of z); it goes on the input columns here, as the row
    # values u_i / l_u / u_u mean.
    n_eq = system.n_eq
    bx_row = n_eq + nx * np.arange(n + 1)
    bu_row = n_eq + nx * (n + 1) + nu * np.arange(n)
    rate_row = n_eq + nx * (n + 1) + nu * n + nu * np.arange(n)
    p_row = n_eq + nx * (n + 1) + 2 * nu * n + npc * np.arange(n + 1)
    a_grids = dict(
        eq_x=_block_grid(eq_row, x_off, nx, nx),
        eq_x_prev=_block_grid(eq_row[1:], x_off[:n], nx, nx),
        eq_u=_block_grid(eq_row[1:], u_off, nx, nu),
        box_x=_block_grid(bx_row, x_off, nx, nx),
        box_u=_block_grid(bu_row, u_off, nu, nu),
        rate_u=_block_grid(rate_row, u_off, dof, dof),
        rate_u_prev=_block_grid(rate_row[1:], u_off[:n - 1], dof, dof),
        poly_x=_block_grid(p_row, x_off, npc, nx),
        poly_u=_block_grid(p_row[:n], u_off, npc, nu))
    return p_grids, a_grids


P_GRIDS, A_GRIDS = _dense_grids()


@functools.cache
def _grid_tensors(device: torch.device):
    """The index grids as tensors on ``device`` (built once per device)."""
    as_t = lambda g: tuple(torch.as_tensor(np.ascontiguousarray(i),
                                           device=device) for i in g)
    return ({k: as_t(g) for k, g in P_GRIDS.items()},
            {k: as_t(g) for k, g in A_GRIDS.items()})


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
    """The discrete (Ad, Bd) as tensors on ``device``, built once per
    (ts, dtype, device, system): callers only read them, and a copy to the
    card per call would be a host sync."""
    return _discrete_ab_cached(float(ts), dtype, str(torch.device(device)),
                               system)


@functools.lru_cache(maxsize=None)
def _discrete_ab_cached(ts: float, dtype, device: str, system: System):
    from ..models.dynamics import discrete_ab
    ad, bd, _ = discrete_ab(ts, system)
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


def build_qp(track: TrackSpline, z: torch.Tensor, rb: RobotData,
             params: MPCCParams, current_u: torch.Tensor, ts,
             exact_heading_jac: bool = False, system: System = PANDA):
    """Assemble the dense normalized QP around the iterates z (B, n_var).

    Returns ``(P, q, A, l, u, obj, constr)``; the normalized step dz solves
    min 1/2 dz'P dz + q'dz  s.t.  l - constr <= A dz <= u - constr (the
    caller forms the offsets).  The blocks never overlap, so each is
    assigned into zeros (the JAX package's scatter-add gives the same).
    """
    if system != PANDA:
        raise NotImplementedError("the dense QP layout is built for the "
                                  "Panda at N = 10 only, as in the JAX "
                                  "package")
    dtype, dev = z.dtype, z.device
    b = z.shape[0]
    nx, nu, dof, n = system.nx, system.nu, system.dof, system.horizon
    norm = params.normalization
    tx, tu = norm.t_x, norm.t_u
    xs, us = split_z(z, system)
    up = us_padded(us)
    p_idx, a_idx = _grid_tensors(dev)

    # batched stage sweep: cost derivatives, normalized blocks
    obj_k, fx, fu, fxx, fuu, fxu = stage_cost(
        track, xs, up, rb, _is_terminal(n, dev), params, exact_heading_jac,
        with_derivatives=True, system=system)
    g_x = fx * tx
    g_u = (fu * tu)[:, :n]
    h_xx = tx[:, None] * fxx * tx[None, :]
    h_uu = (tu[:, None] * fuu * tu[None, :])[:, :n]
    h_xu = (tx[:, None] * fxu * tu[None, :])[:, :n]

    # ddq smoothness cost in the u blocks: interior knots get
    # 2r(2u_i - u_{i+1} - u_{i-1}), the ends are one-sided
    r_ddq = params.cost.r_ddq
    tudq = tu[:dof]
    dq_all = us[..., :dof]
    nbr_sum = torch.cat([dq_all[:, 1:2], dq_all[:, :-2] + dq_all[:, 2:],
                         dq_all[:, -2:-1]], dim=1)
    count = torch.tensor([1.0] + [2.0] * (n - 2) + [1.0], dtype=dtype,
                         device=dev)
    ddq_grad = 2.0 * r_ddq * (count[:, None] * dq_all - nbr_sum)
    g_u[..., :dof] += tudq * ddq_grad
    tu2 = torch.diag(tudq * tudq)
    h_uu[..., :dof, :dof] += (2.0 * r_ddq * count)[:, None, None] * tu2
    off = torch.zeros(nu, nu, dtype=dtype, device=dev)
    off[:dof, :dof] = -2.0 * r_ddq * tu2
    obj = obj_k.sum(-1) + r_ddq * ((dq_all[:, 1:] - dq_all[:, :-1]) ** 2
                                   ).sum((-1, -2))

    p_mat = z.new_zeros(b, system.n_var, system.n_var)
    for name, blk in (("hxx", h_xx), ("huu", h_uu), ("hxu", h_xu),
                      ("hux", h_xu.transpose(-1, -2)), ("huu_next", off),
                      ("huu_prev", off)):
        p_mat[(slice(None),) + p_idx[name]] = blk
    qvec = torch.cat([g_x.reshape(b, -1), g_u.reshape(b, -1)], dim=-1)

    # constraint matrix: equality, bound, rate and polytopic rows
    ad, bd = _discrete_ab(ts, dtype, dev, system)
    tx_inv = norm.t_x_inv
    rate_blk = torch.diag(tudq) / ts
    _, _, _, cx, cu = stage_constraints(
        xs, up, rb, _is_terminal(n, dev), params, with_jacobian=True,
        system=system)
    a_mat = z.new_zeros(b, system.n_constr, system.n_var)
    for name, blk in (
            ("eq_x", torch.eye(nx, dtype=dtype, device=dev)),
            ("eq_x_prev", -(tx_inv[:, None] * ad * tx[None, :])),
            ("eq_u", -(tx_inv[:, None] * bd * tu[None, :])),
            ("box_x", torch.diag(tx)), ("box_u", torch.diag(tu)),
            ("rate_u", rate_blk), ("rate_u_prev", -rate_blk),
            ("poly_x", cx * tx), ("poly_u", cu[:, :n] * tu)):
        a_mat[(slice(None),) + a_idx[name]] = blk

    constr, lvec, uvec = constraint_values(track, z, rb, params, current_u,
                                           ts, system)
    return p_mat, qvec, a_mat, lvec, uvec, obj, constr


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
