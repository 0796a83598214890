"""Stage-wise QP assembly for the Riccati/IPM solvers, batch-first
(`mpcc_manipulator_tpu/ocp/qp_stages.py`).

The normalized QP in stage-separable form with the state augmentation
``x~_k = [x^_k; u^_{k-1}]`` (NXT = 17), which makes the ddq smoothness cost
and rate rows stage-local: :class:`StageQPK`, the blocks the port's K1
reads (:func:`build_qp_stages_k`), repacked by :func:`qpk_to_qps` into
the :class:`StageQPS` the structured IPM solves.

Inequality rows per stage (NC_STAGE = 59), in the packed order:
``[x_u 0..8 | x_l 9..17 | u_u 18..25 | u_l 26..33 | ddq_u 34..40 |
ddq_l 41..47 | polytopic 48..58]``; the state box is active on knots
1..N, the other rows on knots 0..N-1.
"""

from __future__ import annotations

import dataclasses

import torch

from ..params import MPCCParams
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from .constraints import stage_constraints, state_bounds
from .cost import stage_cost
from .qp_data import _discrete_ab, _is_terminal, split_z, us_padded
from .robot_data import RobotData

NXT = PANDA.nxt             # augmented state dim (17)
NZT = PANDA.nzt             # stage variable dim (25)
NC_STAGE = PANDA.nc_stage   # 59


def _cost_blocks_raw(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                     params: MPCCParams, current_u: torch.Tensor, ts,
                     exact_heading_jac: bool, system: System):
    """Raw normalized cost/dynamics blocks, batch-first.

    Returns ``(g_x (B,N+1,nx), g_u (B,N,nu), h_xx (B,N+1,nx,nx),
    h_uu (B,N,nu,nu), h_xu (B,N,nx,nu), two_r (N,), ddq_pair (B,N,dof),
    defect (B,N,nx), xs, us, up)``.
    """
    dtype, dev = z.dtype, z.device
    dof, n_h = system.dof, system.horizon
    tx = params.normalization.t_x
    tu = params.normalization.t_u
    xs, us = split_z(z, system)
    up = us_padded(us)

    _, fx, fu, fxx, fuu, fxu = stage_cost(
        track, xs, up, rb, _is_terminal(n_h, dev), params, exact_heading_jac,
        with_derivatives=True, system=system)
    g_x = fx * tx
    g_u = (fu * tu)[:, :n_h]
    h_xx = tx[:, None] * fxx * tx[None, :]
    h_uu = (tu[:, None] * fuu * tu[None, :])[:, :n_h]
    h_xu = (tx[:, None] * fxu * tu[None, :])[:, :n_h]

    # ddq smoothness: stage k covers the pair (u_k, u_{k-1}) for k = 1..N-1
    pair_mask = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                           torch.ones(n_h - 1, dtype=dtype, device=dev)])
    two_r = 2.0 * params.cost.r_ddq * pair_mask
    dq_all = us[..., :dof]
    dq_prev = torch.cat([current_u[:, None, :dof], dq_all[:, :-1]], dim=1)
    ddq_pair = dq_all - dq_prev

    ad, bd = _discrete_ab(ts, dtype, dev, system)
    pred = xs[:, :-1] @ ad.T + us @ bd.T
    defect = (xs[:, 1:] - pred) * params.normalization.t_x_inv
    return g_x, g_u, h_xx, h_uu, h_xu, two_r, ddq_pair, defect, xs, us, up


def _box_offsets(track: TrackSpline, xs, us, ddq_pair, params: MPCCParams,
                 ts, system: System):
    """``(d_xu, d_xl (B,N+1,nx), d_uu, d_ul (B,N,nu), d_ru, d_rl
    (B,N,dof))``: the box and rate rows' offsets, the s rows clamped to a
    tiny feasible margin (they are weakly controllable over the first
    stages; see the JAX assembly)."""
    s_idx = system.s_idx
    bx_l, bx_u = state_bounds(xs, params, track.length, system)
    d_xu, d_xl = bx_u - xs, xs - bx_l
    d_xu[..., s_idx] = torch.clamp(d_xu[..., s_idx], min=1e-6)
    d_xl[..., s_idx] = torch.clamp(d_xl[..., s_idx], min=1e-6)
    bp = params.bounds
    rate_val = ddq_pair / ts
    return (d_xu, d_xl, bp.u_u - us, us - bp.u_l, bp.ddq_u - rate_val,
            rate_val - bp.ddq_l)


def _expand(t: torch.Tensor, b: int) -> torch.Tensor:
    """A scenario-independent block, one contiguous copy per scenario."""
    return t.expand((b,) + t.shape).contiguous()


@dataclasses.dataclass
class StageQPK:
    """Compact stage blocks for the K1 kernel, every field batch-first."""

    hxx: torch.Tensor      # (B, N+1, NX, NX) per-knot x Hessian (+terminal)
    hux: torch.Tensor      # (B, N, NU, NX)   cross term, u-major
    huu: torch.Tensor      # (B, N, NU, NU)   input Hessian incl. smoothness
    r2: torch.Tensor       # (B, N, DOF)      2 r_ddq tudq^2 (u_prev diag)
    gx: torch.Tensor       # (B, N+1, NX)
    gu: torch.Tensor       # (B, N, NU)       incl. +smoothness gradient
    gxu: torch.Tensor      # (B, N, DOF)      -smoothness gradient
    e: torch.Tensor        # (B, N, NX)       dynamics defect
    a_sv: torch.Tensor     # (B,)
    bd: torch.Tensor       # (B, NX, NU)
    tx: torch.Tensor       # (B, NX)
    tu: torch.Tensor       # (B, NU)
    t_rate: torch.Tensor   # (B, DOF)
    d_xu: torch.Tensor     # (B, N, NX)  state box offsets, knots 1..N
    d_xl: torch.Tensor     # (B, N, NX)
    d_uu: torch.Tensor     # (B, N, NU)
    d_ul: torch.Tensor     # (B, N, NU)
    d_ru: torch.Tensor     # (B, N, DOF)
    d_rl: torch.Tensor     # (B, N, DOF)
    d_p: torch.Tensor      # (B, N, NPC)
    cpx: torch.Tensor      # (B, N, NPC, NX)
    cpu: torch.Tensor      # (B, N, NPC, NU)


def build_qp_stages_k(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                      params: MPCCParams, current_u: torch.Tensor, ts,
                      exact_heading_jac: bool = False,
                      system: System = PANDA) -> StageQPK:
    """Assemble the normalized QP in kernel-block form (contiguous)."""
    dtype, dev = z.dtype, z.device
    b = z.shape[0]
    nx, nu, dof, n_h = system.nx, system.nu, system.dof, system.horizon
    s_idx, vs_idx = system.s_idx, system.vs_idx
    tx = params.normalization.t_x
    tu = params.normalization.t_u
    tx_inv = params.normalization.t_x_inv
    tudq = tu[:dof]

    (g_x, g_u, h_xx, h_uu, h_xu, two_r, ddq_pair, defect,
     xs, us, up) = _cost_blocks_raw(track, z, rb, params, current_u, ts,
                                    exact_heading_jac, system)

    r2 = two_r[:, None] * (tudq * tudq)[None, :]                 # (N, dof)
    r2_u = torch.cat([r2, r2.new_zeros(n_h, nu - dof)], dim=1)
    huu = h_uu + torch.eye(nu, dtype=dtype, device=dev) * r2_u[:, None, :]
    g_sm = two_r[:, None] * tudq[None, :] * ddq_pair
    gu = g_u.clone()
    gu[..., :dof] += g_sm

    a_sv = torch.tensor(float(ts), dtype=dtype, device=dev) * tx[vs_idx] \
        * tx_inv[s_idx]
    _, bd_raw = _discrete_ab(ts, dtype, dev, system)
    bd = tx_inv[:, None] * bd_raw * tu[None, :]

    d_xu, d_xl, d_uu, d_ul, d_ru, d_rl = _box_offsets(
        track, xs, us, ddq_pair, params, ts, system)

    cvals, _, _, cx, cu = stage_constraints(
        xs, up, rb, _is_terminal(n_h, dev), params, with_jacobian=True,
        system=system)

    per_b = lambda t: _expand(t, b)
    return StageQPK(
        hxx=h_xx.contiguous(), hux=h_xu.transpose(-1, -2).contiguous(),
        huu=huu.contiguous(), r2=per_b(r2), gx=g_x.contiguous(),
        gu=gu.contiguous(), gxu=(-g_sm).contiguous(),
        e=(-defect).contiguous(), a_sv=per_b(a_sv), bd=per_b(bd),
        tx=per_b(tx), tu=per_b(tu), t_rate=per_b(tudq / ts),
        d_xu=d_xu[:, 1:].contiguous(), d_xl=d_xl[:, 1:].contiguous(),
        d_uu=d_uu.contiguous(), d_ul=d_ul.contiguous(),
        d_ru=d_ru.contiguous(), d_rl=d_rl.contiguous(),
        d_p=(-cvals[:, :n_h]).contiguous(),
        cpx=(cx * tx)[:, :n_h].contiguous(),
        cpu=(cu * tu)[:, :n_h].contiguous())


@dataclasses.dataclass
class StageQPS:
    """Structured stage-separable normalized QP, batch-first."""

    h: torch.Tensor        # (B, N, NZT, NZT)
    g: torch.Tensor        # (B, N, NZT)
    h_term: torch.Tensor   # (B, NXT, NXT)
    g_term: torch.Tensor   # (B, NXT)
    a_sv: torch.Tensor     # (B,)  Ts * tx[vs] / tx[s]
    bd: torch.Tensor       # (B, NX, NU)
    e: torch.Tensor        # (B, N, NXT)
    tx: torch.Tensor       # (B, NX)
    tu: torch.Tensor       # (B, NU)
    t_rate: torch.Tensor   # (B, DOF)
    d_xu: torch.Tensor     # (B, N+1, NX)
    d_xl: torch.Tensor
    d_uu: torch.Tensor     # (B, N, NU)
    d_ul: torch.Tensor
    d_ru: torch.Tensor     # (B, N, DOF)
    d_rl: torch.Tensor
    cpx: torch.Tensor      # (B, N+1, NPC, NX)
    cpu: torch.Tensor      # (B, N, NPC, NU)
    d_p: torch.Tensor      # (B, N+1, NPC)
    m_x: torch.Tensor      # (B, N+1) state box active for k >= 1
    m_u: torch.Tensor      # (B, N+1) input/rate/polytopic active k <= N-1


def qpk_to_qps(qpk: StageQPK, system: System = PANDA) -> StageQPS:
    """StageQPK -> StageQPS (pure repack; rows StageQPK does not store, the
    knot-0 state box and the terminal polytopic rows, are zero)."""
    b, n_st = qpk.e.shape[:2]
    dtype, dev = qpk.e.dtype, qpk.e.device
    nx, nu, dof = system.nx, system.nu, system.dof
    nxt, nzt = system.nxt, system.nzt
    ar = torch.arange(dof, device=dev)
    h = qpk.hxx.new_zeros(b, n_st, nzt, nzt)
    h[..., :nx, :nx] = qpk.hxx[:, :n_st]
    h[..., :nx, nxt:] = qpk.hux.transpose(-1, -2)
    h[..., nxt:, :nx] = qpk.hux
    h[..., nxt:, nxt:] = qpk.huu
    h[..., nx + ar, nx + ar] += qpk.r2
    h[..., nx + ar, nxt + ar] += -qpk.r2
    h[..., nxt + ar, nx + ar] += -qpk.r2
    g = qpk.gx.new_zeros(b, n_st, nzt)
    g[..., :nx] = qpk.gx[:, :n_st]
    g[..., nxt:] = qpk.gu
    g[..., nx + ar] = qpk.gxu
    h_term = qpk.hxx.new_zeros(b, nxt, nxt)
    h_term[:, :nx, :nx] = qpk.hxx[:, n_st]
    g_term = qpk.gx.new_zeros(b, nxt)
    g_term[:, :nx] = qpk.gx[:, n_st]
    e = qpk.e.new_zeros(b, n_st, nxt)
    e[..., :nx] = qpk.e
    pad1 = lambda a: torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
    padn = lambda a: torch.cat([a, torch.zeros_like(a[:, :1])], dim=1)
    ones = torch.ones(b, n_st, dtype=dtype, device=dev)
    zero = torch.zeros(b, 1, dtype=dtype, device=dev)
    return StageQPS(h=h, g=g, h_term=h_term, g_term=g_term,
                    a_sv=qpk.a_sv, bd=qpk.bd, e=e,
                    tx=qpk.tx, tu=qpk.tu, t_rate=qpk.t_rate,
                    d_xu=pad1(qpk.d_xu), d_xl=pad1(qpk.d_xl),
                    d_uu=qpk.d_uu, d_ul=qpk.d_ul,
                    d_ru=qpk.d_ru, d_rl=qpk.d_rl,
                    cpx=padn(qpk.cpx), cpu=qpk.cpu, d_p=padn(qpk.d_p),
                    m_x=torch.cat([zero, ones], 1),
                    m_u=torch.cat([ones, zero], 1))


def stage_step_to_dense(dx_tilde: torch.Tensor, du: torch.Tensor,
                        system: System = PANDA) -> torch.Tensor:
    """(B, N+1, nxt) augmented-state deltas + (B, N, nu) input deltas ->
    the dense decision-vector step (B, n_var)."""
    b = du.shape[0]
    return torch.cat([dx_tilde[..., :system.nx].reshape(b, -1),
                      du.reshape(b, -1)], dim=-1)
