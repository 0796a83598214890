"""The SQP loop, batch-first (`mpcc_manipulator_tpu/solver/sqp.py::solve_ocp`,
Riccati body).

Per iteration: stage-QP assembly (K2 for ``qp_assembly="pallas"``, the
plain assembly for ``"xla"``) -> NaN guard -> K1 interior-point solve
(warm-started from the carried slacks/duals, clipped off the boundary) ->
optional second-order correction re-solve -> step back to the dense layout
-> filter or l1-merit line search (the trial values from K3 or the plain
evaluation) -> step -> ``eps_prim`` test.

The loop is the JAX ``fleet_mode`` form: ``max_iter`` trips with a per-lane
freeze once a lane is done, equal lane for lane to ``vmap(while_loop)``.
It stops early once every lane is done (one flag read per iteration, none
after the last).  The filter carries its entries from iteration to
iteration, as do the IPM warm iterates.  Under RTI (``rti=True``) every
iteration counts as converged, so the loop ends after its first.  On
failure the returned horizon is the zero-velocity guess (all knots at x0,
inputs zero).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ocp import qp_data
from ..ocp import qp_stages as qps
from ..ocp.robot_data import RobotData
from ..ops import assembly_kernel as ak
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
    sqp_iters: torch.Tensor         # (B,) SQP iterations run
    qp_iters: torch.Tensor          # (B,) Newton iterations of the IPM, summed
    primal_step_norm: torch.Tensor  # (B,)
    success: torch.Tensor           # (B,) status == SOLVED
    ipm_s: torch.Tensor             # (B, N+1, nc_stage) IPM slacks
    ipm_lam: torch.Tensor           # (B, N+1, nc_stage) IPM duals


def check_supported(cfg: SQPConfig, system: System = PANDA) -> None:
    """Reject every configuration the port does not run yet, naming the
    ROADMAP item that ports it (a setting is never silently ignored)."""
    todo = {
        "qp_assembly other than 'pallas' (K2/K3) or 'xla' (plain)":
            cfg.qp_assembly not in ("pallas", "xla"),
        "ipm_scheme='mehrotra' (ROADMAP item 11)": cfg.ipm_scheme != "adaptive",
        "qp_solver='admm' (dense ADMM; ROADMAP item 14)":
            cfg.qp_solver == "admm",
        "line_search other than 'filter' or 'merit'":
            cfg.line_search not in ("filter", "merit"),
        "use_BFGS (dense ADMM; ROADMAP item 14)": cfg.use_BFGS,
        "fleet_mode (the port's loops are per-lane masked already; "
        "ROADMAP 'not to port')": cfg.fleet_mode,
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


def _soc_corrected_rep(rep: qps.StageQPK, sol, z: torch.Tensor, track_length,
                       params: MPCCParams,
                       system: System = PANDA) -> qps.StageQPK:
    """Second-order correction of the StageQPK offsets (JAX
    `_soc_corrected_rep`, ``riccati_pallas`` branch): with RobotData frozen
    for the tick, only the polytopic rows move (``d_p += Cpx dx``) and the
    s trust region re-centres at ``s + ds`` (knots 1..N)."""
    xs, _ = qp_data.split_z(z, system)
    s_idx, n_h = system.s_idx, system.horizon
    tr = params.model.s_trust_region
    dxn = sol.dx_tilde[..., :system.nx]          # (B, N+1, nx) normalized
    s_cur = xs[..., s_idx]
    s_soc = s_cur + dxn[..., s_idx] * params.normalization.t_x[s_idx]
    du_s = torch.clamp(torch.minimum(s_soc + tr, track_length) - s_cur,
                       min=1e-6)
    dl_s = torch.clamp(s_cur - torch.clamp(s_soc - tr, min=0.0), min=1e-6)
    d_xu, d_xl = rep.d_xu.clone(), rep.d_xl.clone()
    d_xu[..., s_idx] = du_s[:, 1:]
    d_xl[..., s_idx] = dl_s[:, 1:]
    d_p = rep.d_p + torch.einsum("bkrz,bkz->bkr", rep.cpx, dxn[:, :n_h])
    return dataclasses.replace(rep, d_p=d_p.contiguous(), d_xu=d_xu,
                               d_xl=d_xl)


def _stage_model_terms(rep: qps.StageQPK, sol, system: System = PANDA):
    """``(q'step, step'H step)`` per lane of the normalized QP model, from
    the StageQPK blocks (JAX `_stage_model_terms`, ``riccati_pallas``
    branch): the merit weight's ingredients."""
    nx, dof, n_h = system.nx, system.dof, system.horizon
    dx = sol.dx_tilde[..., :nx]
    up = sol.dx_tilde[:, :n_h, nx:nx + dof]     # u_{k-1} slots
    du = sol.du
    q_dot = ((rep.gx * dx).sum((1, 2)) + (rep.gu * du).sum((1, 2))
             + (rep.gxu * up).sum((1, 2)))
    quad = (torch.einsum("bkx,bkxy,bky->b", dx, rep.hxx, dx)
            + 2.0 * torch.einsum("bku,bkux,bkx->b", du, rep.hux, dx[:, :n_h])
            + torch.einsum("bku,bkuv,bkv->b", du, rep.huu, du)
            # huu carries +r2 on the du diagonal already; the rest of the
            # u_prev coupling is up^2 - 2 up du
            + (rep.r2 * (up * up - 2.0 * up * du[..., :dof])).sum((1, 2)))
    return q_dot, quad


@dataclasses.dataclass
class _LoopState:
    """Per-lane SQP loop state (frozen on a lane once it is done)."""

    z: torch.Tensor
    f_obj: torch.Tensor     # (B, max_iter+1) filter entries
    f_vio: torch.Tensor
    f_cnt: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    prim_norm: torch.Tensor
    qp_it: torch.Tensor
    done: torch.Tensor
    ipm_s: torch.Tensor
    ipm_lam: torch.Tensor


def solve_ocp(track: TrackSpline, rb: RobotData, params: MPCCParams,
              cfg: SQPConfig, z0: torch.Tensor, current_u: torch.Tensor,
              ts: float, exact_heading_jac: bool = False,
              ipm_s0: torch.Tensor | None = None,
              ipm_lam0: torch.Tensor | None = None,
              system: System = PANDA) -> SQPResult:
    """Run the SQP loop from the warm-start iterates ``z0`` (B, n_var).

    ``ipm_s0``/``ipm_lam0``: packed (B, N+1, nc_stage) interior-point
    iterates, consumed when ``cfg.ipm_warm_start`` is set (ones = cold).
    """
    check_supported(cfg, system)
    dtype, dev = z0.dtype, z0.device
    bsz = z0.shape[0]
    current_u = current_u.contiguous()    # K2/K3 read it row by row
    sqp = params.sqp
    nanany = lambda t: torch.isnan(t).flatten(1).any(-1)
    alpha_fail = sqp.line_search_tau ** cfg.line_search_max_iter
    kernels = cfg.qp_assembly == "pallas"
    assemble = (ak.build_qp_stages_k_kernel if kernels
                else ak.build_qp_stages_k_plain)
    evaluate = ak.eval_point_kernel if kernels else ak.eval_point_plain
    clip = lambda a: torch.clamp(a, cfg.ipm_warm_clip_lo,
                                 cfg.ipm_warm_clip_hi)

    def eval_point(z):
        return evaluate(track, z, rb, params, current_u, ts, system)

    def solve(rep, warm_s, warm_lam):
        if not cfg.ipm_warm_start:
            warm_s = warm_lam = None
        return solve_qp_ipm_k(rep, max_iter=cfg.ipm_max_iter, warm_s=warm_s,
                              warm_lam=warm_lam, system=system)

    def iteration(st: _LoopState) -> _LoopState:
        z = st.z
        rep = assemble(track, z, rb, params, current_u, ts,
                       exact_heading_jac, system)
        has_nan = (nanany(rep.hxx) | nanany(rep.gx) | nanany(rep.cpx)
                   | nanany(rep.d_p) | nanany(rep.d_xu) | nanany(rep.d_xl))
        sol = solve(rep, clip(st.ipm_s), clip(st.ipm_lam))
        qp_used = sol.iters
        if cfg.do_SOC:
            # re-solve against the corrected offsets, warm-started from the
            # first solve; the step is the second solve's
            rep_soc = _soc_corrected_rep(rep, sol, z, track.length, params,
                                         system)
            sol = solve(rep_soc, clip(sol.s_rows.to(dtype)),
                        clip(sol.lam_rows.to(dtype)))
            qp_used = qp_used + sol.iters
        ipm_s, ipm_lam = st.ipm_s, st.ipm_lam
        if cfg.ipm_warm_start:
            # carry the iterates forward; frozen on a NaN and on a diverged
            # but finite solve (mu far off any central path)
            sol_s, sol_lam = sol.s_rows.to(dtype), sol.lam_rows.to(dtype)
            fail_now = (nanany(sol_s) | nanany(sol_lam)
                        | (~sol.solved & (sol.mu > 1e3)))[:, None, None]
            ipm_s = torch.where(fail_now, ipm_s, sol_s)
            ipm_lam = torch.where(fail_now, ipm_lam, sol_lam)

        step = qps.stage_step_to_dense(sol.dx_tilde, sol.du, system).to(dtype)
        guard_fail = has_nan | nanany(step)
        step = torch.where(guard_fail[:, None], torch.zeros_like(step), step)
        dz = qp_data.denormalize_step(step, params, system)

        f_obj, f_vio, f_cnt = st.f_obj, st.f_vio, st.f_cnt
        if cfg.line_search == "merit":
            # l1-merit Armijo backtracking: every candidate step length in
            # one evaluation, the first that satisfies Armijo is taken
            obj0, vio0 = eval_point(z)
            q_dot, quad = _stage_model_terms(rep, sol, system)
            q_dot, quad = q_dot.to(dtype), quad.to(dtype)
            mu = ((q_dot + 0.5 * quad)
                  / ((1.0 - sqp.line_search_rho)
                     * torch.clamp(vio0, min=1e-12)))
            phi0 = obj0 + mu * vio0
            dp_phi = q_dot - mu * vio0
            alphas = sqp.line_search_tau ** torch.arange(
                cfg.line_search_max_iter, dtype=dtype, device=dev)
            obj_a, vio_a = eval_point(z[:, None] + alphas[None, :, None]
                                      * dz[:, None])
            phis = obj_a + mu[:, None] * vio_a
            ok_a = phis <= (phi0[:, None] + alphas[None] * sqp.line_search_eta
                            * dp_phi[:, None])
            first = torch.argmax(ok_a.to(torch.uint8), dim=1)
            alpha = torch.where(ok_a.any(1), alphas[first],
                                alphas[-1] * sqp.line_search_tau)
        else:
            # filter line search: one effective candidate (alpha = 1)
            obj_try, vio_try = eval_point(z + dz)
            dominated = ((obj_try[:, None] >= f_obj)
                         & (vio_try[:, None] >= f_vio)).any(-1)
            accepted = ~dominated
            alpha = torch.where(accepted, torch.ones_like(obj_try),
                                alpha_fail * torch.ones_like(obj_try))
            # on acceptance drop the dominated entries, append at f_cnt
            keep = (obj_try[:, None] > f_obj) | (vio_try[:, None] > f_vio)
            inf = torch.full_like(f_obj, float("inf"))
            f_obj_new = torch.where(keep, f_obj, inf)
            f_vio_new = torch.where(keep, f_vio, inf)
            rows = torch.arange(bsz, device=dev)
            f_obj_new[rows, f_cnt] = obj_try
            f_vio_new[rows, f_cnt] = vio_try
            f_obj = torch.where(accepted[:, None], f_obj_new, f_obj)
            f_vio = torch.where(accepted[:, None], f_vio_new, f_vio)
            f_cnt = torch.where(accepted, f_cnt + 1, f_cnt)
        alpha = alpha.to(dtype)

        prim_norm = alpha * torch.abs(step).amax(-1)
        converged = (prim_norm < sqp.eps_prim) | cfg.rti
        return _LoopState(
            z=torch.where(guard_fail[:, None], z, z + alpha[:, None] * dz),
            f_obj=f_obj, f_vio=f_vio, f_cnt=f_cnt, it=st.it + 1,
            status=torch.where(
                guard_fail, Status.NAN_HESSIAN,
                torch.where(converged, Status.SOLVED,
                            Status.MAX_ITER_EXCEEDED)),
            prim_norm=prim_norm, qp_it=st.qp_it + qp_used,
            done=guard_fail | converged, ipm_s=ipm_s, ipm_lam=ipm_lam)

    ones = torch.ones(bsz, system.horizon + 1, system.nc_stage, dtype=dtype,
                      device=dev)
    long0 = torch.zeros(bsz, dtype=torch.long, device=dev)
    f_init = torch.full((bsz, cfg.max_iter + 1), float("inf"), dtype=dtype,
                        device=dev)
    st = _LoopState(
        z=z0, f_obj=f_init, f_vio=f_init.clone(), f_cnt=long0, it=long0,
        status=torch.full_like(long0, Status.MAX_ITER_EXCEEDED),
        prim_norm=torch.full((bsz,), float("inf"), dtype=dtype, device=dev),
        qp_it=long0, done=torch.zeros(bsz, dtype=torch.bool, device=dev),
        ipm_s=ones if ipm_s0 is None else ipm_s0,
        ipm_lam=ones if ipm_lam0 is None else ipm_lam0)
    for trip in range(cfg.max_iter):
        new = iteration(st)
        frozen = st.done
        st = _LoopState(**{
            f.name: torch.where(
                frozen.view((-1,) + (1,) * (getattr(new, f.name).dim() - 1)),
                getattr(st, f.name), getattr(new, f.name))
            for f in dataclasses.fields(_LoopState)})
        if trip + 1 < cfg.max_iter and bool(st.done.all()):
            break

    success = st.status == Status.SOLVED
    zero_guess = torch.cat([z0[:, :system.nx].repeat(1, system.horizon + 1),
                            z0.new_zeros(bsz, system.nu * system.horizon)],
                           dim=-1)
    return SQPResult(
        z=torch.where(success[:, None], st.z, zero_guess), status=st.status,
        sqp_iters=st.it, qp_iters=st.qp_it, primal_step_norm=st.prim_norm,
        success=success, ipm_s=st.ipm_s, ipm_lam=st.ipm_lam)
