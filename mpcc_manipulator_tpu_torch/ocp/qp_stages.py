"""Stage-wise QP assembly for the Riccati/IPM solvers, batch-first
(`mpcc_manipulator_tpu/ocp/qp_stages.py`).

The normalized QP in stage-separable form with the state augmentation
``x~_k = [x^_k; u^_{k-1}]`` (NXT = 17), which makes the ddq smoothness cost
and rate rows stage-local.  Three representations of the same QP, one per
solver route (``SQPConfig.qp_solver``):

* :class:`StageQP` (``"riccati"``): every stage's rows as a dense
  (nc_stage, nzt) block with a static activity mask, and the dynamics as
  dense (nxt, nxt) / (nxt, nu) maps (:func:`build_qp_stages`);
* :class:`StageQPS` (``"riccati_struct"``): only the nonzero content, the
  box rows as diagonal scales and offsets (:func:`build_qp_stages_s`;
  :func:`pack_stage_qp` packs it into a :class:`StageQP`);
* :class:`StageQPK` (``"riccati_pallas"``): exactly the blocks the K1
  kernel reads (:func:`build_qp_stages_k`; :func:`qpk_to_qps` repacks).

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


def _row_masks(system: System, dtype, device) -> torch.Tensor:
    """(N+1, nc_stage) activity of the packed rows: the state box on knots
    1..N, the input box, rate and polytopic rows on knots 0..N-1."""
    nx, n_h = system.nx, system.horizon
    m = torch.zeros(n_h + 1, system.nc_stage, dtype=dtype, device=device)
    m[1:, :2 * nx] = 1.0
    m[:n_h, 2 * nx:] = 1.0
    return m


def _cost_blocks(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                 params: MPCCParams, current_u: torch.Tensor, ts,
                 exact_heading_jac: bool, system: System):
    """The normalized cost and dynamics blocks in augmented stage
    coordinates, shared by :class:`StageQP` and :class:`StageQPS`:
    ``(h (B,N,nzt,nzt), g (B,N,nzt), h_term (B,nxt,nxt), g_term (B,nxt),
    e (B,N,nxt), xs, us, up, ddq_pair)``."""
    b = z.shape[0]
    nx, dof, n_h = system.nx, system.dof, system.horizon
    nxt, nzt = system.nxt, system.nzt
    tudq = params.normalization.t_u[:dof]

    (g_x, g_u, h_xx, h_uu, h_xu, two_r, ddq_pair, defect,
     xs, us, up) = _cost_blocks_raw(track, z, rb, params, current_u, ts,
                                    exact_heading_jac, system)

    h = z.new_zeros(b, n_h, nzt, nzt)
    h[..., :nx, :nx] = h_xx[:, :n_h]
    h[..., :nx, nxt:] = h_xu
    h[..., nxt:, :nx] = h_xu.transpose(-1, -2)
    h[..., nxt:, nxt:] = h_uu
    g = z.new_zeros(b, n_h, nzt)
    g[..., :nx] = g_x[:, :n_h]
    g[..., nxt:] = g_u
    # ddq smoothness: +2r on u_k and on u^_{k-1}, -2r across
    tu2 = tudq[:, None] * tudq[None, :] * torch.eye(dof, dtype=z.dtype,
                                                    device=z.device)
    blk = two_r[:, None, None] * tu2
    h[..., nxt:nxt + dof, nxt:nxt + dof] += blk
    h[..., nx:nx + dof, nx:nx + dof] += blk
    h[..., nx:nx + dof, nxt:nxt + dof] += -blk
    h[..., nxt:nxt + dof, nx:nx + dof] += -blk
    g_sm = two_r[:, None] * tudq[None, :] * ddq_pair
    g[..., nxt:nxt + dof] += g_sm
    g[..., nx:nx + dof] += -g_sm

    h_term = z.new_zeros(b, nxt, nxt)
    h_term[:, :nx, :nx] = h_xx[:, n_h]
    g_term = z.new_zeros(b, nxt)
    g_term[:, :nx] = g_x[:, n_h]
    e = z.new_zeros(b, n_h, nxt)
    e[..., :nx] = -defect
    return h, g, h_term, g_term, e, xs, us, up, ddq_pair


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


@dataclasses.dataclass
class StageQP:
    """The packed stage-separable normalized QP, batch-first."""

    h: torch.Tensor        # (B, N, NZT, NZT) stage Hessians over (x~, u)
    g: torch.Tensor        # (B, N, NZT)
    h_term: torch.Tensor   # (B, NXT, NXT)
    g_term: torch.Tensor   # (B, NXT)
    at: torch.Tensor       # (B, NXT, NXT)  Delta x~_{k+1} = at Delta x~_k
    bt: torch.Tensor       # (B, NXT, NU)                  + bt Delta u_k + e_k
    e: torch.Tensor        # (B, N, NXT)
    c_rows: torch.Tensor   # (B, N+1, NC_STAGE, NZT) rows @ (x~_k, u_k) <= d
    d_vec: torch.Tensor    # (B, N+1, NC_STAGE)
    mask: torch.Tensor     # (B, N+1, NC_STAGE) 1.0 active / 0.0 inactive


def build_qp_stages(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                    params: MPCCParams, current_u: torch.Tensor, ts,
                    exact_heading_jac: bool = False,
                    system: System = PANDA) -> StageQP:
    """Assemble the normalized QP in the packed dense-row layout (the
    ``"riccati"`` route)."""
    return pack_stage_qp(build_qp_stages_s(track, z, rb, params, current_u,
                                           ts, exact_heading_jac, system),
                         system)


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


def _expand(t: torch.Tensor, b: int) -> torch.Tensor:
    """A scenario-independent block, one contiguous copy per scenario."""
    return t.expand((b,) + t.shape).contiguous()


def build_qp_stages_s(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                      params: MPCCParams, current_u: torch.Tensor, ts,
                      exact_heading_jac: bool = False,
                      system: System = PANDA) -> StageQPS:
    """Assemble the normalized QP in the structured form (the
    ``"riccati_struct"`` route); the dynamics are ``I + a_sv E_{s,vs}`` and
    ``[bd; I]`` exactly."""
    dtype, dev = z.dtype, z.device
    b = z.shape[0]
    n_h, s_idx, vs_idx = system.horizon, system.s_idx, system.vs_idx
    tx = params.normalization.t_x
    tu = params.normalization.t_u
    tx_inv = params.normalization.t_x_inv

    h, g, h_term, g_term, e, xs, us, up, ddq_pair = _cost_blocks(
        track, z, rb, params, current_u, ts, exact_heading_jac, system)
    # a fill, not a copy from the host (which would sync the card)
    a_sv = torch.full((), float(ts), dtype=dtype, device=dev) \
        * tx[vs_idx] * tx_inv[s_idx]
    _, bd_raw = _discrete_ab(ts, dtype, dev, system)
    d_xu, d_xl, d_uu, d_ul, d_ru, d_rl = _box_offsets(
        track, xs, us, ddq_pair, params, ts, system)
    cvals, _, _, cx, cu = stage_constraints(
        xs, up, rb, _is_terminal(n_h, dev), params, with_jacobian=True,
        system=system)
    ones = torch.ones(b, n_h, dtype=dtype, device=dev)
    zero = torch.zeros(b, 1, dtype=dtype, device=dev)
    return StageQPS(
        h=h, g=g, h_term=h_term, g_term=g_term, a_sv=_expand(a_sv, b),
        bd=_expand(tx_inv[:, None] * bd_raw * tu[None, :], b), e=e,
        tx=_expand(tx, b), tu=_expand(tu, b),
        t_rate=_expand(tu[:system.dof] / ts, b),
        d_xu=d_xu, d_xl=d_xl, d_uu=d_uu, d_ul=d_ul, d_ru=d_ru, d_rl=d_rl,
        cpx=cx * tx, cpu=(cu * tu)[:, :n_h], d_p=-cvals,
        m_x=torch.cat([zero, ones], 1), m_u=torch.cat([ones, zero], 1))


def pack_stage_qp(qps: StageQPS, system: System = PANDA) -> StageQP:
    """StageQPS -> the packed :class:`StageQP` (the row layout of
    :func:`build_qp_stages`): every row type but the polytopic is
    diagonal or two-entry."""
    b, n_st = qps.e.shape[:2]
    nx, nu, dof = system.nx, system.nu, system.dof
    nxt, nzt = system.nxt, system.nzt
    dtype, dev = qps.e.dtype, qps.e.device
    at = qps.e.new_zeros(b, nxt, nxt)
    at[:, :nx, :nx] = torch.eye(nx, dtype=dtype, device=dev)
    at[:, system.s_idx, system.vs_idx] += qps.a_sv
    bt = qps.e.new_zeros(b, nxt, nu)
    bt[:, :nx] = qps.bd
    bt[:, nx:] = torch.eye(nu, dtype=dtype, device=dev)
    c = qps.e.new_zeros(b, n_st + 1, system.nc_stage, nzt)
    d = qps.e.new_zeros(b, n_st + 1, system.nc_stage)
    tx_d, tu_d = torch.diag_embed(qps.tx), torch.diag_embed(qps.tu)
    rate = torch.diag_embed(qps.t_rate)
    c[:, :, 0:nx, :nx] = tx_d[:, None]
    c[:, :, nx:2 * nx, :nx] = -tx_d[:, None]
    d[..., 0:nx] = qps.d_xu
    d[..., nx:2 * nx] = qps.d_xl
    o = 2 * nx
    c[:, :n_st, o:o + nu, nxt:] = tu_d[:, None]
    c[:, :n_st, o + nu:o + 2 * nu, nxt:] = -tu_d[:, None]
    d[:, :n_st, o:o + nu] = qps.d_uu
    d[:, :n_st, o + nu:o + 2 * nu] = qps.d_ul
    o = 2 * nx + 2 * nu
    c[:, :n_st, o:o + dof, nxt:nxt + dof] = rate[:, None]
    c[:, :n_st, o:o + dof, nx:nx + dof] = -rate[:, None]
    c[:, :n_st, o + dof:o + 2 * dof, nxt:nxt + dof] = -rate[:, None]
    c[:, :n_st, o + dof:o + 2 * dof, nx:nx + dof] = rate[:, None]
    d[:, :n_st, o:o + dof] = qps.d_ru
    d[:, :n_st, o + dof:o + 2 * dof] = qps.d_rl
    o = 2 * nx + 2 * nu + 2 * dof
    c[:, :, o:, :nx] = qps.cpx
    c[:, :n_st, o:, nxt:] = qps.cpu
    d[..., o:] = qps.d_p
    return StageQP(h=qps.h, g=qps.g, h_term=qps.h_term, g_term=qps.g_term,
                   at=at, bt=bt, e=qps.e, c_rows=c, d_vec=d,
                   mask=_expand(_row_masks(system, dtype, dev), b))


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
