"""MPC orchestration: one control tick for a batch of scenarios
(`mpcc_manipulator_tpu/mpc.py`).

Per tick and per scenario:

1. project s onto the track from the current EE position; recompute
   vs = (Jv dq) . t(s) (K6, `ops/projection_kernel.py`);
2. invalidate the warm start if the projection jumped > max_dist_proj;
3. warm start: shift the horizon and RK4-roll the tail knot, or cold start
   with every knot at x0 -- both computed, selected per lane;
4. one RobotData sweep over the N+1 knots (K4 + the collision NNs), frozen
   for the tick;
5. the SQP loop (`solver/sqp.py`: K2, K1 and K3 inside on the Riccati
   path, K5 on the dense ADMM path), one iteration under RTI (the
   default);
6. the status machine: 5-strike tolerance of MAX_ITER_EXCEEDED.

Everything is batch-first: x0 (B, nx), u0 (B, nu), obs_pos (B, 3),
obs_radius (B,); the track, parameters and networks are shared.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .models import collision_nn as cnn
from .models import dynamics as dyn
from .ocp import qp_data
from .ocp.robot_data import compute_robot_data
from .ops import projection_kernel
from .params import MPCCParams, SQPConfig
from .solver import sqp as sqp_mod
from .splines.arc_length import TrackSpline
from .system import PANDA, System


@dataclasses.dataclass
class MPCCarry:
    """Tick-to-tick solver state per scenario."""

    z_guess: torch.Tensor           # (B, n_var) last horizon (raw units)
    valid_guess: torch.Tensor       # (B,) bool
    num_guess_failed: torch.Tensor  # (B,) int32 consecutive failures
    qp_x: torch.Tensor              # (B, n_var) last ADMM QP primal
    qp_y: torch.Tensor              # (B, n_constr) last ADMM QP dual
    ipm_s: torch.Tensor             # (B, N+1, nc_stage) IPM warm slacks
    ipm_lam: torch.Tensor           # (B, N+1, nc_stage) IPM warm duals


@dataclasses.dataclass
class MPCOutput:
    u0: torch.Tensor          # (B, nu) first optimal input
    x0_updated: torch.Tensor  # (B, nx) state with projected s / re-derived vs
    horizon_x: torch.Tensor   # (B, N+1, nx)
    horizon_u: torch.Tensor   # (B, N, nu)
    status: torch.Tensor      # (B,) Status code
    ok: torch.Tensor          # (B,) bool
    sqp_iters: torch.Tensor   # (B,)
    qp_iters: torch.Tensor    # (B,)


def init_carry(batch: int, dtype=torch.float32, device="cuda",
               system: System = PANDA) -> MPCCarry:
    rows = (batch, system.horizon + 1, system.nc_stage)
    return MPCCarry(
        z_guess=torch.zeros(batch, system.n_var, dtype=dtype, device=device),
        valid_guess=torch.zeros(batch, dtype=torch.bool, device=device),
        num_guess_failed=torch.zeros(batch, dtype=torch.int32, device=device),
        qp_x=torch.zeros(batch, system.n_var, dtype=dtype, device=device),
        qp_y=torch.zeros(batch, system.n_constr, dtype=dtype, device=device),
        ipm_s=torch.ones(rows, dtype=dtype, device=device),
        ipm_lam=torch.ones(rows, dtype=dtype, device=device))


def _shift_warm_start(z: torch.Tensor, x0: torch.Tensor, ts,
                      system: System = PANDA) -> torch.Tensor:
    """Shift knots down by one, pin knot 0 at x0, and RK4-roll the new
    terminal knot; like the reference, x[N-1] copies x[N-2] *after* the
    shift."""
    n = system.horizon
    xs, us = qp_data.split_z(z, system)
    xs_s = torch.cat([x0[:, None], xs[:, 2:], xs[:, -1:]], dim=1)
    us_s = torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    xs_s[:, n - 1] = xs_s[:, n - 2]
    us_s[:, n - 1] = us_s[:, n - 2]
    x_term = dyn.rk4_step(xs_s[:, n - 1], us_s[:, n - 1], ts)
    return qp_data.join_z(torch.cat([xs_s[:, :n], x_term[:, None]], dim=1),
                          us_s)


def _cold_start(x0: torch.Tensor, system: System = PANDA) -> torch.Tensor:
    """Every knot at x0, inputs zero."""
    return torch.cat([x0.repeat(1, system.horizon + 1),
                      x0.new_zeros(x0.shape[0], system.horizon * system.nu)],
                     dim=-1)


def _unwrap_s(z: torch.Tensor, length, system: System = PANDA) -> torch.Tensor:
    """Clamp s of knots 1..N to at most the track length."""
    xs, us = qp_data.split_z(z, system)
    xs = xs.clone()
    xs[:, 1:, system.s_idx] = torch.minimum(xs[:, 1:, system.s_idx], length)
    return qp_data.join_z(xs, us)


def mpc_step(track: TrackSpline, params: MPCCParams, sel_nn: cnn.CollisionMLP,
             env_nn: cnn.CollisionMLP, carry: MPCCarry, x0: torch.Tensor,
             u0: torch.Tensor, obs_pos: torch.Tensor,
             obs_radius: torch.Tensor, ts: float = 0.01,
             cfg: SQPConfig = SQPConfig(), exact_heading_jac: bool = False,
             system: System = PANDA, timer=None
             ) -> tuple[MPCCarry, MPCOutput]:
    """One MPC tick for every scenario; returns the new carry and output.
    ``timer`` (a `solver.sqp_debug.PhaseTimer`) traces the tick: the span
    ``tick`` around it, ``set_env`` (steps 1-4: ``projection``,
    ``warm_start``, ``robot_data``) and the SQP loop's
    (`solver/sqp.py::solve_ocp`)."""
    phase = timer.phase if timer is not None else contextlib.nullcontext
    with phase("tick"):
        sqp_mod.check_supported(cfg, system)
        dof = system.dof

        with phase("set_env"):
            with phase("projection"):
                # --- 1. projection + vs re-derivation (K6 on CUDA tensors)
                last_s = x0[:, system.s_idx]
                x0_new, s_proj = projection_kernel.project_and_vs(
                    track, x0, u0, params.model.max_dist_proj, system,
                    interpret=cfg.ipm_interpret)

            with phase("warm_start"):
                # --- 2. warm-start invalidation on a projection jump
                jumped = (torch.abs(last_s - s_proj)
                          > params.model.max_dist_proj)
                valid = carry.valid_guess & ~jumped
                n_failed = carry.num_guess_failed + jumped.to(torch.int32)

                # --- 3. warm start selection
                z_warm = _unwrap_s(_shift_warm_start(carry.z_guess, x0_new,
                                                     ts, system),
                                   track.length, system)
                z_cold = _unwrap_s(_cold_start(x0_new, system), track.length,
                                   system)
                z0 = torch.where(valid[:, None], z_warm, z_cold)

            with phase("robot_data"):
                # --- 4. per-tick RobotData (frozen linearization cache)
                xs0, _ = qp_data.split_z(z0, system)
                rb = compute_robot_data(
                    xs0[..., :dof].contiguous(), obs_pos, obs_radius, sel_nn,
                    env_nn, mani_grad=cfg.mani_grad, system=system,
                    kin_backend=cfg.kin_backend,
                    kin_interpret=cfg.ipm_interpret,
                    nn_mm_dtype="bfloat16" if cfg.nn_bf16 else None,
                    timer=timer)

        # --- 5. SQP (QP and IPM warm state carried across ticks; zeros /
        # ones on a cold start)
        v2, v3 = valid[:, None], valid[:, None, None]
        res = sqp_mod.solve_ocp(
            track, rb, params, cfg, z0, u0, ts,
            exact_heading_jac=exact_heading_jac,
            qp_x0=torch.where(v2, carry.qp_x, torch.zeros_like(carry.qp_x)),
            qp_y0=torch.where(v2, carry.qp_y, torch.zeros_like(carry.qp_y)),
            ipm_s0=torch.where(v3, carry.ipm_s, torch.ones_like(carry.ipm_s)),
            ipm_lam0=torch.where(v3, carry.ipm_lam,
                                 torch.ones_like(carry.ipm_lam)),
            system=system, timer=timer)

        # --- 6. status machine
        solved = res.success
        n_failed_next = torch.where(solved, torch.zeros_like(n_failed),
                                    n_failed + 1)
        ok = solved | ((res.status == sqp_mod.Status.MAX_ITER_EXCEEDED)
                       & (n_failed_next < 5))
        xs, us = qp_data.split_z(res.z, system)
        # the ADMM path keeps the carry's IPM slots as they were
        admm = cfg.qp_solver == "admm"
        new_carry = MPCCarry(z_guess=res.z, valid_guess=solved,
                             num_guess_failed=n_failed_next, qp_x=res.qp_x,
                             qp_y=res.qp_y,
                             ipm_s=carry.ipm_s if admm else res.ipm_s,
                             ipm_lam=carry.ipm_lam if admm else res.ipm_lam)
        out = MPCOutput(u0=us[:, 0], x0_updated=x0_new, horizon_x=xs,
                        horizon_u=us, status=res.status, ok=ok,
                        sqp_iters=res.sqp_iters, qp_iters=res.qp_iters)
        return new_carry, out
