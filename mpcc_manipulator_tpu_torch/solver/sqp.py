"""SQP iteration, real-time-iteration form, batch-first
(`mpcc_manipulator_tpu/solver/sqp.py::solve_ocp`, Riccati body).

One SQP iteration per tick (RTI): stage-QP assembly -> NaN guard -> K1
interior-point solve (warm-started from the carried slacks/duals, clipped
off the boundary) -> step back to the dense layout -> filter line search ->
step.  RTI folds ``converged`` to true, so the loop ends after its first
iteration whatever ``max_iter`` is.  On failure the returned horizon is the
zero-velocity guess (all knots at x0, inputs zero).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ocp import qp_data
from ..ocp import qp_stages as qps
from ..ocp.robot_data import RobotData
from ..params import MPCCParams, SQPConfig
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from .qp_ipm_kernel import solve_qp_ipm_k


class Status:
    """SQP status codes (mirror the JAX package)."""
    SOLVED = 0
    MAX_ITER_EXCEEDED = 1
    NAN_HESSIAN = 2


@dataclasses.dataclass
class SQPResult:
    z: torch.Tensor                 # (B, n_var) iterate, or zero guess
    status: torch.Tensor            # (B,) Status code
    sqp_iters: torch.Tensor         # (B,)
    qp_iters: torch.Tensor          # (B,) Newton iterations of the IPM
    primal_step_norm: torch.Tensor  # (B,)
    success: torch.Tensor           # (B,) status == SOLVED
    ipm_s: torch.Tensor             # (B, N+1, nc_stage) IPM slacks
    ipm_lam: torch.Tensor           # (B, N+1, nc_stage) IPM duals


def check_supported(cfg: SQPConfig, system: System = PANDA) -> None:
    """Reject every configuration the port does not run yet, naming the
    ROADMAP item that ports it (a setting is never silently ignored)."""
    todo = {
        "qp_assembly='pallas' (the K2 assembly kernel; ROADMAP section 2, K2)":
            cfg.qp_assembly != "xla",
        "ipm_scheme='mehrotra' (ROADMAP item 11)": cfg.ipm_scheme != "adaptive",
        "qp_solver='admm' (dense ADMM; ROADMAP item 14)":
            cfg.qp_solver == "admm",
        "do_SOC (ROADMAP item 11)": cfg.do_SOC,
        "line_search='merit' (ROADMAP item 11)": cfg.line_search != "filter",
        "use_BFGS (dense ADMM; ROADMAP item 14)": cfg.use_BFGS,
        "fleet_mode (the port's loops are per-lane masked already; "
        "ROADMAP 'not to port')": cfg.fleet_mode,
        "the converged mode rti=False (ROADMAP item 11)": not cfg.rti,
        "nn_bf16 (ROADMAP 'not to port')": cfg.nn_bf16,
        "mani_grad other than 'analytic' (ROADMAP item 11)":
            cfg.mani_grad != "analytic",
        "qp_solver other than the K1 route 'riccati_pallas' (the plain "
        "version runs for CPU tensors)":
            cfg.qp_solver not in ("riccati_pallas", "admm"),
        "kin_backend other than the K4 route 'pallas' (the plain version "
        "runs for CPU tensors)": cfg.kin_backend != "pallas",
        "ipm_interpret (no interpret mode exists in the port)":
            cfg.ipm_interpret is not None,
        "a system other than the Panda (ROADMAP item 12)":
            system.base_dof != 0,
        "max_iter < 1": cfg.max_iter < 1,
    }
    missing = [k for k, v in todo.items() if v]
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def constraint_norm(constr, l, u):
    """Per-lane l1 violation of ``l <= c <= u``."""
    return (torch.clamp(l - constr, min=0.0).sum(-1)
            + torch.clamp(constr - u, min=0.0).sum(-1))


def solve_ocp(track: TrackSpline, rb: RobotData, params: MPCCParams,
              cfg: SQPConfig, z0: torch.Tensor, current_u: torch.Tensor,
              ts: float, exact_heading_jac: bool = False,
              ipm_s0: torch.Tensor | None = None,
              ipm_lam0: torch.Tensor | None = None,
              system: System = PANDA) -> SQPResult:
    """One RTI SQP iteration from the warm-start iterates ``z0`` (B, n_var).

    ``ipm_s0``/``ipm_lam0``: packed (B, N+1, nc_stage) interior-point
    iterates, consumed when ``cfg.ipm_warm_start`` is set (ones = cold).
    """
    check_supported(cfg, system)
    dtype, dev = z0.dtype, z0.device
    bsz = z0.shape[0]
    sqp = params.sqp
    ones = torch.ones(bsz, system.horizon + 1, system.nc_stage, dtype=dtype,
                      device=dev)
    ipm_s = ones if ipm_s0 is None else ipm_s0
    ipm_lam = ones if ipm_lam0 is None else ipm_lam0
    alpha_fail = sqp.line_search_tau ** cfg.line_search_max_iter
    nanany = lambda t: torch.isnan(t).flatten(1).any(-1)

    def eval_point(z):
        obj = qp_data.total_objective(track, z, rb, params, exact_heading_jac,
                                      system=system)
        constr, lo, hi = qp_data.constraint_values(track, z, rb, params,
                                                   current_u, ts, system)
        return obj, constraint_norm(constr, lo, hi)

    # filter state: (obj, violation) pairs of accepted iterates
    max_filter = cfg.max_iter + 1
    f_obj = torch.full((bsz, max_filter), float("inf"), dtype=dtype,
                       device=dev)
    f_vio = f_obj.clone()
    f_cnt = torch.zeros(bsz, dtype=torch.long, device=dev)
    z = z0

    # ---- the single RTI iteration
    if cfg.ipm_warm_start:
        clip = lambda a: torch.clamp(a, cfg.ipm_warm_clip_lo,
                                     cfg.ipm_warm_clip_hi)
        ws, wl = clip(ipm_s), clip(ipm_lam)
    else:
        ws = wl = None
    rep = qps.build_qp_stages_k(track, z, rb, params, current_u, ts,
                                exact_heading_jac, system=system)
    has_nan = (nanany(rep.hxx) | nanany(rep.gx) | nanany(rep.cpx)
               | nanany(rep.d_p) | nanany(rep.d_xu) | nanany(rep.d_xl))
    sol = solve_qp_ipm_k(rep, max_iter=cfg.ipm_max_iter, warm_s=ws,
                         warm_lam=wl, system=system)
    sol_s, sol_lam = sol.s_rows.to(dtype), sol.lam_rows.to(dtype)

    if cfg.ipm_warm_start:
        # carry the iterates forward; frozen on a NaN and on a diverged
        # but finite solve (mu far off any central path)
        fail_now = (nanany(sol_s) | nanany(sol_lam)
                    | (~sol.solved & (sol.mu > 1e3)))[:, None, None]
        ipm_s = torch.where(fail_now, ipm_s, sol_s)
        ipm_lam = torch.where(fail_now, ipm_lam, sol_lam)

    step = qps.stage_step_to_dense(sol.dx_tilde, sol.du, system).to(dtype)
    guard_fail = has_nan | nanany(step)
    step = torch.where(guard_fail[:, None], torch.zeros_like(step), step)
    dz = qp_data.denormalize_step(step, params, system)

    # ---- filter line search: one effective candidate (alpha = 1)
    obj_try, vio_try = eval_point(z + dz)
    dominated = ((obj_try[:, None] >= f_obj)
                 & (vio_try[:, None] >= f_vio)).any(-1)
    accepted = ~dominated
    alpha = torch.where(accepted, torch.ones_like(obj_try),
                        alpha_fail * torch.ones_like(obj_try))
    # filter update on acceptance (drop dominated entries, write slot
    # f_cnt): the state a further SQP iteration would test against; under
    # RTI none follows (the converged mode is ROADMAP item 11)
    keep = (obj_try[:, None] > f_obj) | (vio_try[:, None] > f_vio)
    rows = torch.arange(bsz, device=dev)
    f_obj_new = torch.where(keep, f_obj, torch.full_like(f_obj, float("inf")))
    f_vio_new = torch.where(keep, f_vio, torch.full_like(f_vio, float("inf")))
    f_obj_new[rows, f_cnt] = obj_try
    f_vio_new[rows, f_cnt] = vio_try
    f_obj = torch.where(accepted[:, None], f_obj_new, f_obj)
    f_vio = torch.where(accepted[:, None], f_vio_new, f_vio)
    f_cnt = torch.where(accepted, f_cnt + 1, f_cnt)

    z_new = z + alpha[:, None] * dz
    prim_norm = alpha * torch.abs(step).amax(-1)
    # RTI: the completed iteration is the solve
    converged = (prim_norm < sqp.eps_prim) | cfg.rti
    z = torch.where(guard_fail[:, None], z, z_new)
    status = torch.where(
        guard_fail, Status.NAN_HESSIAN,
        torch.where(converged, Status.SOLVED, Status.MAX_ITER_EXCEEDED))

    success = status == Status.SOLVED
    zero_guess = torch.cat([z0[:, :system.nx].repeat(1, system.horizon + 1),
                            z0.new_zeros(bsz, system.nu * system.horizon)],
                           dim=-1)
    return SQPResult(
        z=torch.where(success[:, None], z, zero_guess), status=status,
        sqp_iters=torch.ones(bsz, dtype=torch.long, device=dev),
        qp_iters=sol.iters, primal_step_norm=prim_norm, success=success,
        ipm_s=ipm_s, ipm_lam=ipm_lam)
