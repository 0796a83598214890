"""The SQP loop, batch-first (`mpcc_manipulator_tpu/solver/sqp.py::solve_ocp`).

Two bodies, routed by ``cfg.qp_solver``:

* the Riccati family: stage-QP assembly -> NaN guard -> interior-point
  solve in ``cfg.ipm_scheme`` (adaptive or Mehrotra centering;
  warm-started from the carried slacks/duals, clipped off the boundary) ->
  optional second-order correction re-solve -> step back to the dense
  layout -> filter or l1-merit line search.  Three routes, one QP:

  - ``"riccati_pallas"``: the kernel blocks StageQPK (K2 for
    ``qp_assembly="pallas"``, the plain assembly for ``"xla"``) solved by
    K1, the trial values from K3 or the plain evaluation;
  - ``"riccati_struct"``: the structured StageQPS and the plain
    ``qp_ipm.solve_qp_ipm_s``;
  - ``"riccati"``: the packed StageQP and the plain ``qp_ipm.solve_qp_ipm``;

  the last two with the plain evaluation (``qp_assembly="xla"``, as JAX
  requires);
* ``"admm"``: the dense QP (``build_qp``) -> optional damped BFGS update of
  the Lagrangian Hessian -> NaN / positive-definiteness guard (jittered
  Cholesky) -> ADMM QP solve (K5 for ``qp_backend="pallas"``, its plain
  version for ``"pallas_interpret"``, the plain loop for ``"xla"``),
  warm-started from the last QP's primal
  and dual -> optional second-order correction (a cold re-solve) -> filter
  or l1-merit line search on the plain evaluation -> step and dual update;

then the ``eps_prim`` test.  The loop is the JAX ``fleet_mode`` form:
``max_iter`` trips with a per-lane freeze once a lane is done, equal lane
for lane to ``vmap(while_loop)``.  It stops early once every lane is done
(one flag read per iteration, none after the last); with ``cfg.fleet_mode``
it runs all ``max_iter`` trips and never reads the flag, and the plain
IPMs run all their trips too (``fixed_iters``), so neither loop syncs the
host (K1 keeps its per-scenario loop on the device).  The filter carries
its entries from iteration to iteration, as do the IPM warm iterates and
the ADMM warm start.  Under RTI (``rti=True``) every iteration counts as
converged, so the loop ends after its first.  On failure the returned
horizon is the zero-velocity guess (all knots at x0, inputs zero).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import operator

import torch

from ..ocp import qp_data
from ..ocp import qp_stages as qps
from ..ocp.robot_data import (KIN_BACKENDS, MANI_GRADS, RobotData,
                              check_kin_route)
from ..ops import assembly_kernel as ak
from ..ops.admm_kernel import mv
from ..ops.cuda_build import check_interpret
from ..params import MPCCParams, SQPConfig
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from . import qp_admm, qp_ipm
from .qp_ipm import SCHEMES
from .qp_ipm_kernel import env_rows_active, solve_qp_ipm_k

QP_SOLVERS = ("riccati_pallas", "riccati_struct", "riccati", "admm")


class Status:
    """SQP status codes (mirror the JAX package)."""
    SOLVED = 0
    MAX_ITER_EXCEEDED = 1
    NAN_HESSIAN = 2
    NON_PD_HESSIAN = 3
    QP_NOT_CONVERGED = 4   # ADMM hit its iteration cap with large residuals


@dataclasses.dataclass
class SQPResult:
    z: torch.Tensor                 # (B, n_var) iterate, or zero guess
    lam: torch.Tensor               # (B, n_constr) duals (ADMM path)
    status: torch.Tensor            # (B,) Status code
    sqp_iters: torch.Tensor         # (B,) SQP iterations run
    qp_iters: torch.Tensor          # (B,) IPM Newton / ADMM iterations, summed
    primal_step_norm: torch.Tensor  # (B,)
    success: torch.Tensor           # (B,) status == SOLVED
    qp_x: torch.Tensor              # (B, n_var) last QP primal (ADMM)
    qp_y: torch.Tensor              # (B, n_constr) last QP dual
    ipm_s: torch.Tensor             # (B, N+1, nc_stage) IPM slacks
    ipm_lam: torch.Tensor           # (B, N+1, nc_stage) IPM duals


def check_supported(cfg: SQPConfig, system: System = PANDA) -> None:
    """Raise the JAX package's ``ValueError`` for an inconsistent
    configuration, and a ``ValueError`` for a value no route has (a
    setting is never silently ignored).  ``ipm_interpret`` takes JAX's
    three values; it names the route of K1-K4
    (`ops/cuda_build.kernel_route`)."""
    if system.name != "panda" and cfg.qp_solver == "admm":
        raise ValueError(
            "the dense ADMM backend is Panda-only (OSQP-conformance path); "
            "use qp_solver='riccati' for other systems")
    if cfg.qp_assembly == "pallas" and cfg.qp_solver != "riccati_pallas":
        raise ValueError(
            "qp_assembly='pallas' requires qp_solver='riccati_pallas' "
            "(the kernel assembly emits the kernel-direct StageQPK blocks)")
    check_kin_route(cfg.mani_grad, cfg.kin_backend, system)
    if cfg.use_BFGS and cfg.qp_solver.startswith("riccati"):
        raise ValueError(
            "use_BFGS requires the dense ADMM backend (qp_solver='admm'): "
            "the structured Riccati/IPM path factors exact stage Hessians "
            "and is structurally incompatible with a dense BFGS carry")
    unknown = {
        "qp_solver": (cfg.qp_solver, QP_SOLVERS),
        "qp_assembly": (cfg.qp_assembly, ("pallas", "xla")),
        "ipm_scheme": (cfg.ipm_scheme, SCHEMES),
        "qp_backend": (cfg.qp_backend, qp_admm.BACKENDS),
        "line_search": (cfg.line_search, ("filter", "merit")),
        "mani_grad": (cfg.mani_grad, MANI_GRADS),
        "kin_backend": (cfg.kin_backend, KIN_BACKENDS),
    }
    for name, (value, known) in unknown.items():
        if value not in known:
            raise ValueError(f"{name}={value!r}: expected one of {known}")
    if cfg.max_iter < 0:
        raise ValueError(f"max_iter={cfg.max_iter} < 0")
    check_interpret(cfg.ipm_interpret, "ipm_interpret")


# the per-lane l1 violation of l <= c <= u (JAX `sqp.constraint_norm`)
constraint_norm = qp_data.constraint_norm


def _soc_corrected_rep(rep, sol, z: torch.Tensor, track_length,
                       params: MPCCParams, solver: str = "riccati_pallas",
                       system: System = PANDA):
    """Second-order correction of the stage-QP offsets (JAX
    `_soc_corrected_rep`): with RobotData frozen for the tick, only the
    polytopic rows move (``d_p += Cpx dx``) and the s trust region
    re-centres at ``s + ds``.  ``solver`` names the representation:
    StageQPK (``"riccati_pallas"``: knots 1..N / 0..N-1), StageQPS
    (``"riccati_struct"``: knots 0..N) or the packed StageQP."""
    xs, _ = qp_data.split_z(z, system)
    s_idx, nx, n_h = system.s_idx, system.nx, system.horizon
    tr = params.model.s_trust_region
    dxn = sol.dx_tilde[..., :nx]                 # (B, N+1, nx) normalized
    s_cur = xs[..., s_idx]
    s_soc = s_cur + dxn[..., s_idx] * params.normalization.t_x[s_idx]
    du_s = torch.clamp(torch.minimum(s_soc + tr, track_length) - s_cur,
                       min=1e-6)
    dl_s = torch.clamp(s_cur - torch.clamp(s_soc - tr, min=0.0), min=1e-6)
    poly = lambda cpx, dx: torch.einsum("bkrz,bkz->bkr", cpx, dx)
    if solver == "riccati_pallas":
        d_xu, d_xl = rep.d_xu.clone(), rep.d_xl.clone()
        d_xu[..., s_idx] = du_s[:, 1:]
        d_xl[..., s_idx] = dl_s[:, 1:]
        d_p = rep.d_p + poly(rep.cpx, dxn[:, :n_h])
        return dataclasses.replace(rep, d_p=d_p.contiguous(), d_xu=d_xu,
                                   d_xl=d_xl)
    if solver == "riccati_struct":
        d_xu, d_xl = rep.d_xu.clone(), rep.d_xl.clone()
        d_xu[..., s_idx] = du_s
        d_xl[..., s_idx] = dl_s
        return dataclasses.replace(rep, d_p=rep.d_p + poly(rep.cpx, dxn),
                                   d_xu=d_xu, d_xl=d_xl)
    # packed rows: [x_u | x_l | ... | polytopic]
    o = 2 * nx + 2 * system.nu + 2 * system.dof
    d_vec = rep.d_vec.clone()
    d_vec[..., o:] += poly(rep.c_rows[..., o:, :nx], dxn)
    d_vec[..., s_idx] = du_s
    d_vec[..., nx + s_idx] = dl_s
    return dataclasses.replace(rep, d_vec=d_vec)


def _stage_model_terms(rep, sol, solver: str = "riccati_pallas",
                       system: System = PANDA):
    """``(q'step, step'H step)`` per lane of the normalized QP model, from
    the stage blocks (JAX `_stage_model_terms`): the merit weight's
    ingredients.  ``solver`` names the representation, as for
    :func:`_soc_corrected_rep`."""
    nx, dof, n_h = system.nx, system.dof, system.horizon
    dxt, du = sol.dx_tilde, sol.du
    if solver != "riccati_pallas":
        # StageQP and StageQPS share the (h, g, h_term, g_term) layout
        zs = torch.cat([dxt[:, :n_h], du], dim=-1)
        x_n = dxt[:, n_h]
        q_dot = (rep.g * zs).sum((1, 2)) + (rep.g_term * x_n).sum(-1)
        quad = (torch.einsum("bkz,bkzv,bkv->b", zs, rep.h, zs)
                + torch.einsum("bz,bzv,bv->b", x_n, rep.h_term, x_n))
        return q_dot, quad
    dx = dxt[..., :nx]
    up = dxt[:, :n_h, nx:nx + dof]              # u_{k-1} slots
    q_dot = ((rep.gx * dx).sum((1, 2)) + (rep.gu * du).sum((1, 2))
             + (rep.gxu * up).sum((1, 2)))
    quad = (torch.einsum("bkx,bkxy,bky->b", dx, rep.hxx, dx)
            + 2.0 * torch.einsum("bku,bkux,bkx->b", du, rep.hux, dx[:, :n_h])
            + torch.einsum("bku,bkuv,bkv->b", du, rep.huu, du)
            # huu carries +r2 on the du diagonal already; the rest of the
            # u_prev coupling is up^2 - 2 up du
            + (rep.r2 * (up * up - 2.0 * up * du[..., :dof])).sum((1, 2)))
    return q_dot, quad


def _riccati_route(cfg: SQPConfig, system: System):
    """``(assemble, NaN-guarded fields, solve)`` of the Riccati route
    ``cfg.qp_solver``; ``solve(rep, warm_s, warm_lam)``.  K1 and K2 take
    the route ``cfg.ipm_interpret`` names."""
    kw = dict(max_iter=cfg.ipm_max_iter, scheme=cfg.ipm_scheme)
    if cfg.qp_solver == "riccati_pallas":
        # K1 keeps its per-scenario loop on the device: no fixed_iters
        return ((functools.partial(ak.build_qp_stages_k_kernel,
                                   interpret=cfg.ipm_interpret)
                 if cfg.qp_assembly == "pallas"
                 else ak.build_qp_stages_k_plain),
                ("hxx", "gx", "cpx", "d_p", "d_xu", "d_xl"),
                lambda r, ws, wl: solve_qp_ipm_k(
                    r, warm_s=ws, warm_lam=wl, system=system,
                    interpret=cfg.ipm_interpret, **kw))
    if cfg.qp_solver == "riccati_struct":
        return (qps.build_qp_stages_s,
                ("h", "g", "cpx", "d_p", "d_xu", "d_xl"),
                lambda r, ws, wl: qp_ipm.solve_qp_ipm_s(
                    r, warm_s=ws, warm_lam=wl, fixed_iters=cfg.fleet_mode,
                    **kw))
    return (qps.build_qp_stages, ("h", "g", "c_rows", "d_vec"),
            lambda r, ws, wl: qp_ipm.solve_qp_ipm(
                r, warm_s=ws, warm_lam=wl, fixed_iters=cfg.fleet_mode, **kw))


def _bfgs_update(hess, step_prev, delta_grad_l):
    """Damped BFGS per lane (`OsqpInterface::BFGSUpdate`, Nocedal Proc.
    18.2): hess (B, n, n), step_prev and delta_grad_l (B, n)."""
    bs = mv(hess, step_prev)
    s_bs = (step_prev * bs).sum(-1)
    sy = (step_prev * delta_grad_l).sum(-1)
    damped = sy < 0.2 * s_bs
    theta = torch.where(damped, 0.8 * s_bs / torch.clamp(s_bs - sy,
                                                          min=1e-300),
                        torch.ones_like(s_bs))
    r = theta[:, None] * delta_grad_l + (1.0 - theta)[:, None] * bs
    sr = theta * sy + (1.0 - theta) * s_bs
    outer = lambda v, w: v[:, :, None] * w[:, None, :]
    upd = (hess - outer(bs, bs) / torch.clamp(s_bs, min=1e-300)[:, None, None]
           + outer(r, r) / sr[:, None, None])
    ok = sr >= torch.finfo(hess.dtype).eps
    return torch.where(ok[:, None, None], upd, hess)


def _hessian_guard(hess: torch.Tensor):
    """``(guard_fail, guard status)`` per lane: a jittered Cholesky of the
    Hessian (jitter ``n_var eps max|diag H|``: the GN q-block is nearly
    rank 6, so an unjittered float32 factorization fails on roundoff),
    NAN_HESSIAN where it holds a NaN, NON_PD_HESSIAN where it is not
    positive definite."""
    n = hess.shape[-1]
    eye = torch.eye(n, dtype=hess.dtype, device=hess.device)
    jitter = (n * torch.finfo(hess.dtype).eps
              * hess.diagonal(dim1=-2, dim2=-1).abs().amax(-1))
    chol = qp_admm.cholesky_nan(hess + jitter[:, None, None] * eye)
    non_pd = torch.isnan(chol).flatten(1).any(-1)
    has_nan = torch.isnan(hess).flatten(1).any(-1)
    status = torch.where(has_nan, Status.NAN_HESSIAN, Status.NON_PD_HESSIAN)
    return non_pd | has_nan, status


@dataclasses.dataclass
class _LoopState:
    """Per-lane SQP loop state (frozen on a lane once it is done)."""

    z: torch.Tensor
    lam: torch.Tensor       # (B, n_constr) duals (ADMM path)
    f_obj: torch.Tensor     # (B, max_iter+1) filter entries
    f_vio: torch.Tensor
    f_cnt: torch.Tensor
    hess: torch.Tensor      # (B, n_var, n_var) BFGS carry, else (B, 1, 1)
    grad_l: torch.Tensor    # (B, n_var) Lagrangian gradient, else (B, 1)
    step_prev: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    prim_norm: torch.Tensor
    qp_it: torch.Tensor
    done: torch.Tensor
    qp_x: torch.Tensor      # ADMM warm start (unscaled primal / dual)
    qp_y: torch.Tensor
    ipm_s: torch.Tensor
    ipm_lam: torch.Tensor


def solve_ocp(track: TrackSpline, rb: RobotData, params: MPCCParams,
              cfg: SQPConfig, z0: torch.Tensor, current_u: torch.Tensor,
              ts: float, exact_heading_jac: bool = False,
              qp_x0: torch.Tensor | None = None,
              qp_y0: torch.Tensor | None = None,
              ipm_s0: torch.Tensor | None = None,
              ipm_lam0: torch.Tensor | None = None,
              system: System = PANDA, timer=None) -> SQPResult:
    """Run the SQP loop from the warm-start iterates ``z0`` (B, n_var).

    ``qp_x0``/``qp_y0``: (B, n_var) / (B, n_constr) warm start of the first
    ADMM solve (zeros = cold).  ``ipm_s0``/``ipm_lam0``: packed
    (B, N+1, nc_stage) interior-point iterates, consumed when
    ``cfg.ipm_warm_start`` is set (ones = cold).  Each path passes the
    other's warm state through unchanged.  ``timer`` (a
    `sqp_debug.PhaseTimer`) traces the phases set_qp (the assembly:
    ``assembly``, or ``build_qp`` and ``hessian_guard``), solve_qp (the QP
    solves: ``ipm``, or `qp_admm.solve_qp`'s spans) and get_alpha (the
    line search: ``eval``) of every iteration; a counting timer also keeps
    the Riccati solve's ``env_rows_active`` on its solve_qp span.
    """
    check_supported(cfg, system)
    phase = timer.phase if timer is not None else contextlib.nullcontext
    dtype, dev = z0.dtype, z0.device
    bsz = z0.shape[0]
    n_var, n_constr = system.n_var, system.n_constr
    current_u = current_u.contiguous()    # K2/K3 read it row by row
    sqp = params.sqp
    nanany = lambda t: torch.isnan(t).flatten(1).any(-1)
    alpha_fail = sqp.line_search_tau ** cfg.line_search_max_iter
    riccati = cfg.qp_solver != "admm"
    evaluate = (functools.partial(ak.eval_point_kernel,
                                  interpret=cfg.ipm_interpret)
                if cfg.qp_assembly == "pallas" else ak.eval_point_plain)
    if riccati:
        assemble, nan_fields, solve_route = _riccati_route(cfg, system)
    clip = lambda a: torch.clamp(a, cfg.ipm_warm_clip_lo,
                                 cfg.ipm_warm_clip_hi)

    def eval_point(z):
        with phase("eval"):
            return evaluate(track, z, rb, params, current_u, ts, system)

    def solve(rep, warm_s, warm_lam):
        if not cfg.ipm_warm_start:
            warm_s = warm_lam = None
        return solve_route(rep, warm_s, warm_lam)

    def solve_dense(p, q, a, lo, hi, **warm):
        return qp_admm.solve_qp(p, q, a, lo, hi, max_iter=cfg.qp_max_iter,
                                check_every=cfg.qp_check_every,
                                backend=cfg.qp_backend, timer=timer, **warm)

    def line_search(z, dz, st, merit_terms):
        """``(alpha, f_obj, f_vio, f_cnt)``: the l1-merit Armijo search
        over every candidate step length in one evaluation (the first that
        satisfies Armijo is taken; all rejected falls through with one more
        tau decay), or the filter's one effective candidate (alpha = 1).
        ``merit_terms()`` gives ``(obj0, vio0, q'step, step'H step)``."""
        f_obj, f_vio, f_cnt = st.f_obj, st.f_vio, st.f_cnt
        if cfg.line_search == "merit":
            obj0, vio0, q_dot, quad = merit_terms()
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
            return alpha.to(dtype), f_obj, f_vio, f_cnt
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
        return alpha.to(dtype), f_obj, f_vio, f_cnt

    def riccati_iteration(st: _LoopState) -> _LoopState:
        z = st.z
        with phase("set_qp"):
            with phase("assembly"):
                rep = assemble(track, z, rb, params, current_u, ts,
                               exact_heading_jac, system)
            has_nan = functools.reduce(operator.or_, (
                nanany(getattr(rep, f)) for f in nan_fields))
        with phase("solve_qp"):
            with phase("ipm"):
                sol = solve(rep, clip(st.ipm_s), clip(st.ipm_lam))
            qp_used = sol.iters
            if cfg.do_SOC:
                # re-solve against the corrected offsets, warm-started from
                # the first solve; the step is the second solve's
                rep_soc = _soc_corrected_rep(rep, sol, z, track.length,
                                             params, cfg.qp_solver, system)
                with phase("ipm"):
                    sol = solve(rep_soc, clip(sol.s_rows.to(dtype)),
                                clip(sol.lam_rows.to(dtype)))
                qp_used = qp_used + sol.iters
            if timer is not None and timer.count_ops:
                timer.keep("env_rows_active", env_rows_active(
                    sol.s_rows, sol.lam_rows, system))
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

        def merit_terms():
            obj0, vio0 = eval_point(z)
            q_dot, quad = _stage_model_terms(rep, sol, cfg.qp_solver,
                                             system)
            return obj0, vio0, q_dot.to(dtype), quad.to(dtype)

        with phase("get_alpha"):
            alpha, f_obj, f_vio, f_cnt = line_search(z, dz, st, merit_terms)
        prim_norm = alpha * torch.abs(step).amax(-1)
        converged = (prim_norm < sqp.eps_prim) | cfg.rti
        return dataclasses.replace(
            st, z=torch.where(guard_fail[:, None], z, z + alpha[:, None] * dz),
            f_obj=f_obj, f_vio=f_vio, f_cnt=f_cnt, it=st.it + 1,
            status=torch.where(
                guard_fail, Status.NAN_HESSIAN,
                torch.where(converged, Status.SOLVED,
                            Status.MAX_ITER_EXCEEDED)),
            prim_norm=prim_norm, qp_it=st.qp_it + qp_used,
            done=guard_fail | converged, ipm_s=ipm_s, ipm_lam=ipm_lam)

    def admm_iteration(st: _LoopState) -> _LoopState:
        z = st.z
        with phase("set_qp"):
            with phase("build_qp"):
                p_mat, qvec, a_mat, lvec, uvec, obj, constr = (
                    qp_data.build_qp(track, z, rb, params, current_u, ts,
                                     exact_heading_jac, system))
            hess, grad_l = p_mat, st.grad_l
            if cfg.use_BFGS:
                grad_l = qvec + mv(a_mat.transpose(-1, -2), st.lam)
                hess = torch.where(
                    (st.it == 0)[:, None, None], p_mat,
                    _bfgs_update(st.hess, st.step_prev, grad_l - st.grad_l))
            with phase("hessian_guard"):
                guard_fail, guard_status = _hessian_guard(hess)

        with phase("solve_qp"):
            # QP solve, warm-started from the last QP's primal and dual
            warm = (dict(x_warm=st.qp_x, y_warm=st.qp_y)
                    if cfg.qp_warm_start else {})
            qp_sol = solve_dense(hess, qvec, a_mat, lvec - constr,
                                 uvec - constr, **warm)
            step, y_qp = qp_sol.x, qp_sol.y
            if cfg.do_SOC:
                # second-order correction: constraints re-evaluated at
                # z + dz, d = c(z + dz) - A dz, and a cold re-solve
                c_soc, l_soc, u_soc = qp_data.constraint_values(
                    track, z + qp_data.denormalize_step(step, params, system),
                    rb, params, current_u, ts, system)
                d = c_soc - mv(a_mat, step)
                qp_sol2 = solve_dense(hess, qvec, a_mat, l_soc - d, u_soc - d)
                step, y_qp = qp_sol2.x, qp_sol2.y
        dz = qp_data.denormalize_step(step, params, system)

        def merit_terms():
            return (obj, qp_data.constraint_norm(constr, lvec, uvec),
                    (qvec * step).sum(-1), (step * mv(hess, step)).sum(-1))

        with phase("get_alpha"):
            alpha, f_obj, f_vio, f_cnt = line_search(z, dz, st, merit_terms)
        prim_norm = alpha * torch.abs(step).amax(-1)
        converged = (prim_norm < sqp.eps_prim) | cfg.rti
        a_col = alpha[:, None]
        return dataclasses.replace(
            st, z=torch.where(guard_fail[:, None], z, z + a_col * dz),
            lam=torch.where(guard_fail[:, None], st.lam,
                            st.lam + a_col * (y_qp - st.lam)),
            f_obj=f_obj, f_vio=f_vio, f_cnt=f_cnt,
            hess=hess if cfg.use_BFGS else st.hess, grad_l=grad_l,
            step_prev=a_col * step, it=st.it + 1,
            status=torch.where(
                guard_fail, guard_status,
                torch.where(converged, Status.SOLVED,
                            Status.MAX_ITER_EXCEEDED)),
            prim_norm=prim_norm, qp_it=st.qp_it + qp_sol.iters,
            done=guard_fail | converged, qp_x=qp_sol.x, qp_y=qp_sol.y)

    iteration = riccati_iteration if riccati else admm_iteration
    ones = torch.ones(bsz, system.horizon + 1, system.nc_stage, dtype=dtype,
                      device=dev)
    zeros = lambda *shape: torch.zeros(bsz, *shape, dtype=dtype, device=dev)
    long0 = torch.zeros(bsz, dtype=torch.long, device=dev)
    f_init = torch.full((bsz, cfg.max_iter + 1), float("inf"), dtype=dtype,
                        device=dev)
    # the dense BFGS carry exists only where BFGS consumes it
    h_dim = n_var if cfg.use_BFGS else 1
    st = _LoopState(
        z=z0, lam=zeros(n_constr), f_obj=f_init, f_vio=f_init.clone(),
        f_cnt=long0, hess=zeros(h_dim, h_dim), grad_l=zeros(h_dim),
        step_prev=zeros(n_var), it=long0,
        status=torch.full_like(long0, Status.MAX_ITER_EXCEEDED),
        prim_norm=torch.full((bsz,), float("inf"), dtype=dtype, device=dev),
        qp_it=long0, done=torch.zeros(bsz, dtype=torch.bool, device=dev),
        qp_x=zeros(n_var) if qp_x0 is None else qp_x0,
        qp_y=zeros(n_constr) if qp_y0 is None else qp_y0,
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
        if (not cfg.fleet_mode and trip + 1 < cfg.max_iter
                and bool(st.done.all())):
            break

    success = st.status == Status.SOLVED
    zero_guess = torch.cat([z0[:, :system.nx].repeat(1, system.horizon + 1),
                            z0.new_zeros(bsz, system.nu * system.horizon)],
                           dim=-1)
    return SQPResult(
        z=torch.where(success[:, None], st.z, zero_guess), lam=st.lam,
        status=st.status, sqp_iters=st.it, qp_iters=st.qp_it,
        primal_step_norm=st.prim_norm, success=success, qp_x=st.qp_x,
        qp_y=st.qp_y, ipm_s=st.ipm_s, ipm_lam=st.ipm_lam)
