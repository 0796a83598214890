"""Dense ADMM QP solver, batch-first
(`mpcc_manipulator_tpu/solver/qp_admm.py`).

Solves, for every scenario of a batch,  min 1/2 x'Px + q'x  s.t.
l <= Ax <= u  with OSQP's operator splitting: modified Ruiz equilibration
(10 sweeps), per-row rho (equality rows x 1e3), the explicit inverse of
K = P + sigma I + A' diag(rho) A, one ``check_every``-iteration chunk, one
adaptive-rho point with a second factorization, then the remaining budget,
and the unscaled OSQP termination test.  The iteration cap plays the role
of the reference's time limit: running out of iterations is not a failure.

Two routes run the iteration chunks (``backend``):

* ``"xla"``: the plain chunk loop in the input dtype, each lane frozen once
  it is done (lane for lane the JAX ``vmap(while_loop)``), on any device;
  the float64 conformance route, and the route of the JAX package's
  ``api.MPCC`` default.
* ``"pallas"``: K5 (`ops/admm_kernel.fused_admm`), one launch for phase 1
  and one for phase 2, in float32, with the kernel's own entry test; the
  residuals are then recomputed in the caller's dtype to decide ``done``.
  On CPU tensors the kernel's plain version runs.
* ``"pallas_interpret"``: the same with K5's plain version on either
  device (`ops/admm_kernel.fused_admm_plain`; JAX runs its kernel in the
  Pallas interpreter).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..config import INF
from ..ops import admm_kernel
from ..ops.admm_kernel import mv

SIGMA = 1e-6
ALPHA = 1.6            # relaxation
RHO_BASE = 0.1
RHO_EQ_SCALE = 1e3     # OSQP: equality rows get rho * 1e3
RHO_MIN, RHO_MAX = 1e-6, 1e6
EPS_ABS = 1e-4
EPS_REL = 1e-5
RUIZ_ITERS = 10
BACKENDS = ("xla", "pallas", "pallas_interpret")


@dataclasses.dataclass
class QPSolution:
    x: torch.Tensor          # (B, n) primal step
    y: torch.Tensor          # (B, m) dual
    solved: torch.Tensor     # (B,) converged to the eps tolerances
    iters: torch.Tensor      # (B,) iterations used
    prim_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor   # (B,)


def check_route(backend: str) -> None:
    """Raise unless ``backend`` is one of JAX's: ``"xla"`` (the plain
    loop), ``"pallas"`` (K5, or its plain version for CPU tensors) or
    ``"pallas_interpret"`` (K5's plain version), each on any device."""
    if backend not in BACKENDS:
        raise ValueError(f"qp_backend {backend!r}: expected one of "
                         f"{BACKENDS}")


def _tT(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _ruiz_equilibrate(p, q, a, l, u):
    """Modified Ruiz equilibration of the stacked KKT matrix, per scenario.

    Returns scaled (P, q, A, l, u) and the scalings d (B, n), e (B, m) and
    the cost scalar c (B,), with  P_s = c D P D,  A_s = E A D,  q_s = c D q,
    l_s = E l.  Structurally zero rows and columns (the dVs slots of the
    ddq rate rows) keep scale 1, and the +-INF bounds stay unscaled.
    """
    b, m, n = a.shape
    d = p.new_ones(b, n)
    e = p.new_ones(b, m)
    c = p.new_ones(b)
    p_s, q_s, a_s = p, q, a
    one = torch.ones((), dtype=p.dtype, device=p.device)
    for _ in range(RUIZ_ITERS):
        a_abs = a_s.abs()
        col_norm = torch.maximum(p_s.abs().amax(-2), a_abs.amax(-2))
        delta_d = torch.where(col_norm < 1e-12, one, one / col_norm.sqrt())
        row_norm = a_abs.amax(-1)
        delta_e = torch.where(row_norm < 1e-12, one, one / row_norm.sqrt())
        p_s = delta_d[:, :, None] * p_s * delta_d[:, None, :]
        q_s = delta_d * q_s
        a_s = delta_e[:, :, None] * a_s * delta_d[:, None, :]
        d = d * delta_d
        e = e * delta_e
        # cost scaling: normalise the mean column norm of P / inf-norm of q
        p_col = p_s.abs().amax(-2)
        gamma = one / torch.clamp(torch.maximum(p_col.mean(-1),
                                                q_s.abs().amax(-1)), min=1e-12)
        p_s = p_s * gamma[:, None, None]
        q_s = q_s * gamma[:, None]
        c = c * gamma
    scaled = lambda v: torch.where(torch.isfinite(v) & (v.abs() < INF / 2),
                                   e * v, v)
    return p_s, q_s, a_s, scaled(l), scaled(u), d, e, c


def cholesky_nan(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the matrix is not positive definite
    (or holds a NaN), as JAX's ``cholesky`` returns; never synchronizes."""
    chol, info = torch.linalg.cholesky_ex(k)
    bad = (info != 0) | torch.isnan(k).flatten(-2).any(-1)
    return torch.where(bad[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def _factor(p, a, rho):
    """Inverse of K = P + sigma I + A' diag(rho) A for every scenario."""
    n = p.shape[-1]
    eye = torch.eye(n, dtype=p.dtype, device=p.device)
    k = p + SIGMA * eye + torch.matmul(_tT(a) * rho[:, None, :], a)
    inv_l = torch.linalg.solve_triangular(cholesky_nan(k), eye.expand_as(k),
                                          upper=False)
    return torch.matmul(_tT(inv_l), inv_l)


def residuals(p_s, q_s, a_s, d_scl, e_scl, c_scl, x, z, y):
    """Unscaled OSQP residuals ``(r_prim, r_dual, s_prim, s_dual)``, (B,)
    each, of the equilibrated iterate (x, z, y)."""
    ax, px, aty = mv(a_s, x), mv(p_s, x), mv(_tT(a_s), y)
    r_prim = ((ax - z) / e_scl).abs().amax(-1)
    r_dual = (d_scl * (px + q_s + aty) / c_scl[:, None]).abs().amax(-1)
    s_prim = torch.maximum((ax / e_scl).abs().amax(-1),
                           (z / e_scl).abs().amax(-1))
    s_dual = torch.maximum(torch.maximum(
        (d_scl * px).abs().amax(-1), (d_scl * aty).abs().amax(-1)),
        (d_scl * q_s).abs().amax(-1)) / c_scl
    return r_prim, r_dual, s_prim, s_dual


def _rho0(l_s, u_s):
    """The OSQP per-row rho: equality rows x 1e3."""
    full = lambda v: torch.full_like(l_s, v)
    return torch.where((u_s - l_s).abs() < 1e-12,
                       full(RHO_BASE * RHO_EQ_SCALE), full(RHO_BASE))


def equilibrated(p, q, a, l, u):
    """The scaled problem K5 works on: ``(P_s, q_s, A_s, l_s, u_s, d, e, c,
    rho0, K0^-1)`` with the OSQP per-row rho (equality rows x 1e3)."""
    p_s, q_s, a_s, l_s, u_s, d, e, c = _ruiz_equilibrate(p, q, a, l, u)
    rho0 = _rho0(l_s, u_s)
    return p_s, q_s, a_s, l_s, u_s, d, e, c, rho0, _factor(p_s, a_s, rho0)


def solve_qp(p, q, a, l, u, max_iter: int = 400, check_every: int = 25,
             x_warm=None, y_warm=None, backend: str = "xla",
             timer=None) -> QPSolution:
    """Solve a batch of dense QPs: p (B, n, n), q (B, n), a (B, m, n),
    l, u (B, m).

    The default is the cold start (x = z = y = 0).  ``x_warm``/``y_warm``
    (unscaled, (B, n) / (B, m)) warm-start the splitting.  ``timer`` (a
    `sqp_debug.PhaseTimer`) traces the spans ``ruiz``, ``factor`` (each
    factorization) and ``admm`` (each run of iterations: one K5 launch on
    the kernel routes), keeping each run's iterations per lane.
    """
    check_route(backend)
    phase = timer.phase if timer is not None else contextlib.nullcontext
    keep = timer.keep if timer is not None else lambda key, value: None
    dtype = p.dtype
    b, m, n = a.shape

    with phase("ruiz"):
        p_s, q_s, a_s, l_s, u_s, d_scl, e_scl, c_scl = _ruiz_equilibrate(
            p, q, a, l, u)
        rho0 = _rho0(l_s, u_s)
    with phase("factor"):
        kinv0 = _factor(p_s, a_s, rho0)
    c_col = c_scl[:, None]
    res = lambda x, z, y: residuals(p_s, q_s, a_s, d_scl, e_scl, c_scl, x,
                                    z, y)

    def converged(x, z, y):
        r_p, r_d, s_p, s_d = res(x, z, y)
        return (r_p <= EPS_ABS + EPS_REL * s_p) & (r_d <= EPS_ABS
                                                   + EPS_REL * s_d)

    def admm_iters(x, z, y, rho, kinv, n_iters):
        """``n_iters`` plain ADMM iterations (no termination checks)."""
        for _ in range(n_iters):
            rhs = SIGMA * x - q_s + mv(_tT(a_s), rho * z - y)
            x = mv(kinv, rhs)
            z_relax = ALPHA * mv(a_s, x) + (1.0 - ALPHA) * z
            z1 = torch.minimum(torch.maximum(z_relax + y / rho, l_s), u_s)
            y = y + rho * (z_relax - z1)
            z = z1
        return x, z, y

    def run_chunks(x, z, y, rho, kinv, budget: int, done):
        """Chunks of ``check_every`` until converged or ``budget`` spent;
        returns (x, z, y, iterations used, done)."""
        if backend.startswith("pallas"):
            with phase("admm"):
                f32 = lambda t: t.to(torch.float32).contiguous()
                x, z, y, it = admm_kernel.fused_admm(
                    f32(kinv), f32(p_s), f32(a_s), f32(q_s), f32(rho),
                    f32(l_s), f32(u_s), f32(d_scl), f32(e_scl), f32(c_scl),
                    f32(x), f32(z), f32(y), max_iter=budget,
                    check_every=check_every, sigma=SIGMA, alpha=ALPHA,
                    eps_abs=EPS_ABS, eps_rel=EPS_REL,
                    interpret=True if backend == "pallas_interpret" else None)
                x, z, y = x.to(dtype), z.to(dtype), y.to(dtype)
                keep("iters", it)
            return x, z, y, it, converged(x, z, y)
        with phase("admm"):
            it = torch.zeros(b, dtype=torch.long, device=p.device)
            while True:
                active = ~done & (it < budget)
                if not bool(active.any()):
                    keep("iters", it)
                    return x, z, y, it, done
                xn, zn, yn = admm_iters(x, z, y, rho, kinv, check_every)
                act = active[:, None]
                x = torch.where(act, xn, x)
                z = torch.where(act, zn, z)
                y = torch.where(act, yn, y)
                it = torch.where(active, it + check_every, it)
                done = torch.where(active, converged(x, z, y), done)

    if x_warm is None:
        x0 = p.new_zeros(b, n)
        z0 = p.new_zeros(b, m)
        y0 = p.new_zeros(b, m)
    else:
        # scale the unscaled warm start into the equilibrated space
        x0 = x_warm / d_scl
        z0 = mv(a_s, x0)
        y0 = c_col * y_warm / e_scl

    # phase 1: one check interval, then a single adaptive-rho point (the
    # batched factorizations stay at exactly two)
    no = torch.zeros(b, dtype=torch.bool, device=p.device)
    x, z, y, it1, done0 = run_chunks(x0, z0, y0, rho0, kinv0, check_every,
                                     no)
    r_p, r_d, s_p, s_d = res(x, z, y)
    ratio = torch.sqrt((r_p / torch.clamp(s_p, min=1e-12))
                       / torch.clamp(r_d / torch.clamp(s_d, min=1e-12),
                                     min=1e-12))
    adapt = ~done0 & ((ratio > 5.0) | (ratio < 0.2))
    rho = torch.where(adapt[:, None],
                      torch.clamp(rho0 * ratio[:, None], RHO_MIN, RHO_MAX),
                      rho0)
    with phase("factor"):
        kinv = torch.where(adapt[:, None, None], _factor(p_s, a_s, rho),
                           kinv0)

    # phase 2: the remaining budget
    x, z, y, it2, done = run_chunks(x, z, y, rho, kinv,
                                    max(max_iter - check_every, 0), done0)
    r_p, r_d, _, _ = res(x, z, y)
    return QPSolution(x=d_scl * x, y=e_scl * y / c_col, solved=done,
                      iters=it1 + it2, prim_res=r_p, dual_res=r_d)
