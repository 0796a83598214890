"""Structured QP solvers: primal-dual interior point + Riccati recursion,
batch-first (`mpcc_manipulator_tpu/solver/qp_ipm.py`).

:func:`solve_qp_ipm_s`, the plain version of the port's K1 kernel, with
both centering schemes of the JAX functions (adaptive, and Mehrotra's
predictor-corrector against a saved factorization) and optional warm
start, on the structured :class:`~..ocp.qp_stages.StageQPS`: its rows are
seven exact-shape groups per stage, ``(xu, xl, uu, ul, ru, rl, p)``; the
state box covers knots 1..N, the input / rate / polytopic rows knots
0..N-1.

The Newton loop is a fixed-trip loop with per-lane freeze masks -- a lane
stops updating once it has converged or diverged, the semantics of
``vmap(while_loop)``.  By default it returns early once every lane is
frozen (one flag read on the host per iteration; no result changes);
``fixed_iters=True`` (JAX's fleet mode) runs all ``max_iter`` trips and
never reads the flag.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ocp.qp_stages import StageQPS
from ..utils.linalg_small import cho_solve_small, cholesky_small

# Complementarity target (a constant here; the JAX package reads an
# environment override for its ablations).
EPS_IPM = 1e-5
FRAC_TO_BOUNDARY = 0.995
SCHEMES = ("adaptive", "mehrotra")   # centering schemes (solve_qp_ipm_s)


@dataclasses.dataclass
class IPMSolution:
    dx_tilde: torch.Tensor  # (B, N+1, nxt) augmented-state step
    du: torch.Tensor        # (B, N, nu) input step
    lam: torch.Tensor       # (B, N+1, nc_stage) duals (0.0 on unused rows)
    iters: torch.Tensor     # (B,) int
    solved: torch.Tensor    # (B,) bool
    mu: torch.Tensor        # (B,)
    s_rows: torch.Tensor    # (B, N+1, nc_stage) slacks (1.0 on unused rows)
    lam_rows: torch.Tensor  # (B, N+1, nc_stage) duals (1.0 on unused rows)


def rows_to_groups(rows: torch.Tensor, nx: int) -> torch.Tensor:
    """Packed (B, N+1, nc) rows -> (B, N, nc) stage rows in group order:
    the state box of knot k+1 and the other groups of knot k."""
    return torch.cat([rows[:, 1:, :2 * nx], rows[:, :-1, 2 * nx:]], dim=-1)


def groups_to_rows(cat: torch.Tensor, base: float, nx: int) -> torch.Tensor:
    """Inverse of :func:`rows_to_groups`; unused rows hold ``base``."""
    b, n_st, nc = cat.shape
    rows = torch.full((b, n_st + 1, nc), base, dtype=cat.dtype,
                      device=cat.device)
    rows[:, 1:, :2 * nx] = cat[..., :2 * nx]
    rows[:, :-1, 2 * nx:] = cat[..., 2 * nx:]
    return rows


def _riccati_backward_s(qp: StageQPS, hbar, gbar, hbar_term, gbar_term,
                      with_vectors: bool = True):
    """Structured backward sweep: ``(k_gains, k_ffs, fact)``.  With
    ``with_vectors`` the matrix and vector recursions run fused; without,
    only the matrix recursion runs (``k_ffs`` are zero) and ``fact = (P's
    x-columns, Cholesky factors, s_bars)`` per stage supports later
    vector-only sweeps (:func:`_riccati_ff_s`)."""
    bd, a_sv = qp.bd, qp.a_sv[:, None]
    nx, nu = bd.shape[-2:]
    nxt = nx + nu
    s_idx, vs_idx = nx - 2, nx - 1
    bdt = bd.transpose(-1, -2)
    eye_u = torch.eye(nu, dtype=bd.dtype, device=bd.device)
    p_mat, p_vec = hbar_term, gbar_term
    n_st = hbar.shape[1]
    k_gains, k_ffs = [None] * n_st, [None] * n_st
    p_xs, chols, s_bars = [None] * n_st, [None] * n_st, [None] * n_st
    for k in reversed(range(n_st)):
        h_k = hbar[:, k]
        pa_x = p_mat[:, :, :nx].clone()
        pa_x[:, :, vs_idx] += a_sv * p_mat[:, :, s_idx]
        contrib = pa_x[:, :nx, :].clone()
        contrib[:, vs_idx, :] += a_sv * pa_x[:, s_idx, :]
        q_bar = h_k[:, :nxt, :nxt].clone()
        q_bar[:, :nx, :nx] += contrib
        s_bar = h_k[:, nxt:, :nxt].clone()
        s_bar[:, :, :nx] += bdt @ pa_x[:, :nx, :] + pa_x[:, nx:, :]
        pb = p_mat[:, :, :nx] @ bd + p_mat[:, :, nx:]
        r_bar = h_k[:, nxt:, nxt:] + bdt @ pb[:, :nx, :] + pb[:, nx:, :]
        chol = cholesky_small(r_bar + 1e-9 * eye_u, nu)
        p_xs[k], chols[k], s_bars[k] = p_mat[:, :, :nx], chol, s_bar
        if with_vectors:
            qx_bar, ru_bar = _riccati_vector_s(qp, k, p_mat[:, :, :nx], p_vec,
                                             gbar[:, k])
            sol = -cho_solve_small(
                chol, torch.cat([s_bar, ru_bar[..., None]], dim=-1), nu)
            k_gains[k], k_ffs[k] = sol[..., :nxt], sol[..., nxt]
            p_vec = (qx_bar
                     + (s_bar.transpose(-1, -2) @ k_ffs[k][..., None])[..., 0])
        else:
            k_gains[k] = -cho_solve_small(chol, s_bar, nu)
            k_ffs[k] = torch.zeros_like(h_k[:, 0, :nu])
        p_new = q_bar + s_bar.transpose(-1, -2) @ k_gains[k]
        p_mat = 0.5 * (p_new + p_new.transpose(-1, -2))
    return k_gains, k_ffs, (p_xs, chols, s_bars)


def _riccati_vector_s(qp: StageQPS, k: int, p_x, p_vec, g_k):
    """One vector Riccati step against P_{k+1}'s x-columns ``p_x``:
    ``(qx_bar, ru_bar)``."""
    bd, a_sv = qp.bd, qp.a_sv
    nx, nu = bd.shape[-2:]
    nxt = nx + nu
    s_idx, vs_idx = nx - 2, nx - 1
    m_vec = p_vec + (p_x @ qp.e[:, k, :nx, None])[..., 0]
    qx_bar = g_k[:, :nxt].clone()
    qx_bar[:, :nx] += m_vec[:, :nx]
    qx_bar[:, vs_idx] += a_sv * m_vec[:, s_idx]
    bdt_m = (bd.transpose(-1, -2) @ m_vec[:, :nx, None])[..., 0]
    ru_bar = g_k[:, nxt:] + bdt_m + m_vec[:, nx:]
    return qx_bar, ru_bar


def _riccati_ff_s(qp: StageQPS, fact, k_gains, gbar, gbar_term):
    """Vector-only backward sweep against a saved factorization, then the
    forward rollout (the Mehrotra probe and corrector)."""
    nu = qp.bd.shape[-1]
    p_xs, chols, s_bars = fact
    p_vec = gbar_term
    k_ffs = [None] * len(k_gains)
    for k in reversed(range(len(k_gains))):
        qx_bar, ru_bar = _riccati_vector_s(qp, k, p_xs[k], p_vec, gbar[:, k])
        k_ffs[k] = -cho_solve_small(chols[k], ru_bar, nu)
        p_vec = (qx_bar
                 + (s_bars[k].transpose(-1, -2) @ k_ffs[k][..., None])[..., 0])
    return _riccati_forward_s(qp, k_gains, k_ffs)


def _riccati_forward_s(qp: StageQPS, k_gains, k_ffs):
    """Rollout dx'_{k+1} = at dx'_k + bt du_k + e_k from dx'_0 = 0."""
    nx = qp.bd.shape[-2]
    s_idx, vs_idx = nx - 2, nx - 1
    dx = qp.e.new_zeros(qp.e.shape[0], qp.e.shape[2])
    dxs, dus = [dx], []
    for k in range(len(k_gains)):
        du_k = (k_gains[k] @ dx[..., None])[..., 0] + k_ffs[k]
        x_next = dx[:, :nx].clone()
        x_next[:, s_idx] += qp.a_sv * dx[:, vs_idx]
        x_next = x_next + (qp.bd @ du_k[..., None])[..., 0] + qp.e[:, k, :nx]
        dx = torch.cat([x_next, du_k], dim=-1)
        dxs.append(dx)
        dus.append(du_k)
    return torch.stack(dxs, dim=1), torch.stack(dus, dim=1)


def _check_scheme(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown IPM scheme {scheme!r}; expected one of "
                         f"{SCHEMES}")


def _max_alpha(v, dv):
    """Fraction-to-boundary step length per lane, over every row."""
    neg = dv < -1e-12
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                        torch.full_like(v, float("inf")))
    return torch.clamp(FRAC_TO_BOUNDARY * ratio.amin((-1, -2)), max=1.0)


def _newton_loop(scheme, max_iter, fixed_iters, dx, du, s, lam, newton,
                 mean, residual):
    """The interior-point iterations, per lane: ``newton(s, lam)`` factors
    the iteration's Newton system and returns ``solve_rhs(rhs) -> (dx, du,
    s, lam)`` targets for a complementarity right-hand side; ``mean``
    averages rows over the active ones; ``residual`` is the largest
    |C z + s - d|.  A lane freezes once it has converged or diverged; a
    non-finite update is not taken.  Returns ``(dx, du, s, lam,
    iterations)``."""
    bsz, dev = s.shape[0], s.device
    mu = mean(s * lam)
    it = torch.zeros(bsz, dtype=torch.int64, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    col = lambda v: v[:, None, None]
    for _ in range(max_iter):
        solve_rhs = newton(s, lam)
        if scheme == "mehrotra":
            # affine probe, then the centering corrector with the
            # second-order term
            mu_meas = mean(s * lam)
            _, _, s_a, lam_a = solve_rhs(torch.zeros_like(s))
            ds_a, dlam_a = s_a - s, lam_a - lam
            a_p_aff = col(_max_alpha(s, ds_a))
            a_d_aff = col(_max_alpha(lam, dlam_a))
            mu_aff = mean((s + a_p_aff * ds_a) * (lam + a_d_aff * dlam_a))
            sigma_m = torch.clamp(
                (mu_aff / torch.clamp(mu_meas, min=1e-12)) ** 3, 1e-4, 1.0)
            rhs = col(sigma_m * mu_meas) - ds_a * dlam_a
        else:
            rhs = col(mu).expand_as(s)
        dx_t, du_t, s_t, lam_t = solve_rhs(rhs)
        step_s = s_t - s
        step_lam = lam_t - lam
        alpha_p = _max_alpha(s, step_s)
        alpha_d = _max_alpha(lam, step_lam)

        dx_n = dx + col(alpha_p) * (dx_t - dx)
        du_n = du + col(alpha_p) * (du_t - du)
        s_n = s + col(alpha_p) * step_s
        lam_n = lam + col(alpha_d) * step_lam
        finite = (torch.isfinite(dx_n).all((-1, -2))
                  & torch.isfinite(du_n).all((-1, -2))
                  & torch.isfinite(s_n).all((-1, -2))
                  & torch.isfinite(lam_n).all((-1, -2)))
        # frozen lanes keep their carry; a non-finite update is not taken
        upd = col(~done & finite)
        dx = torch.where(upd, dx_n, dx)
        du = torch.where(upd, du_n, du)
        s = torch.where(upd, s_n, s)
        lam = torch.where(upd, lam_n, lam)

        r_ineq = residual(dx, du, s)
        mu_post = mean(s * lam)
        alpha_min = torch.minimum(alpha_p, alpha_d)
        sigma = torch.clamp((1.0 - alpha_min) ** 2, 0.1, 0.8)
        mu = torch.where(done, mu, torch.clamp(sigma * mu_post,
                                               min=0.01 * EPS_IPM))
        stop = ((mu_post < EPS_IPM) & (r_ineq < 2e-4)) | ~finite \
            | (mu_post > 1e6)
        it = it + (~done).long()
        done = done | stop
        if not fixed_iters and bool(done.all()):
            break
    return dx, du, s, lam, it


def solve_qp_ipm_s(qp: StageQPS, max_iter: int = 25,
                   scheme: str = "adaptive", fixed_iters: bool = False,
                   warm_s: torch.Tensor | None = None,
                   warm_lam: torch.Tensor | None = None) -> IPMSolution:
    """Interior-point solve of a batch of structured stage QPs.

    ``scheme``: ``"adaptive"`` (one fused matrix + vector sweep per Newton
    iteration against the carried barrier parameter) or ``"mehrotra"``
    (the matrix sweep once per iteration, then an affine probe and a
    centering corrector as vector-only sweeps against the saved
    factorization).  ``warm_s``/``warm_lam``: packed (B, N+1, nc_stage)
    warm-start iterates; ``None`` is the cold start (all ones).
    ``fixed_iters``: run all ``max_iter`` trips, no early exit.
    """
    _check_scheme(scheme)
    dtype, dev = qp.e.dtype, qp.e.device
    bsz, n_st = qp.e.shape[:2]
    nx, nu = qp.bd.shape[-2:]
    dof = qp.t_rate.shape[-1]
    npc = qp.d_p.shape[-1]
    nxt = nx + nu
    widths = (nx, nx, nu, nu, dof, dof, npc)   # row groups, packed order
    nc = sum(widths)
    m_act = float(n_st * nc)
    ar_x = torch.arange(nx, device=dev)
    ar_u = torch.arange(nu, device=dev)
    ar_d = torch.arange(dof, device=dev)
    cpx = qp.cpx[:, :n_st]
    tx, tu, tr = qp.tx[:, None], qp.tu[:, None], qp.t_rate[:, None]
    d_all = torch.cat([qp.d_xu[:, 1:], qp.d_xl[:, 1:], qp.d_uu, qp.d_ul,
                       qp.d_ru, qp.d_rl, qp.d_p[:, :n_st]], dim=-1)

    def split(rows):
        return torch.split(rows, widths, dim=-1)

    def row_dots(dx_all, du_all):
        """C z for every stage row, (B, N, nc) in group order."""
        cz_x = tx * dx_all[:, 1:, :nx]
        cz_u = tu * du_all
        cz_r = tr * (du_all[..., :dof] - dx_all[:, :n_st, nx:nx + dof])
        cz_p = (torch.einsum("bkrz,bkz->bkr", cpx, dx_all[:, :n_st, :nx])
                + torch.einsum("bkrz,bkz->bkr", qp.cpu, du_all))
        return torch.cat([cz_x, -cz_x, cz_u, -cz_u, cz_r, -cz_r, cz_p], -1)

    def gradient(r_g):
        """gbar, gbar_term from the (B, N, nc) gradient rows."""
        r_xu, r_xl, r_uu, r_ul, r_ru, r_rl, r_p = split(r_g)
        gx_box = tx * (r_xu - r_xl)
        gr = tr * (r_ru - r_rl)
        gbar = qp.g.clone()
        gbar[..., :nx] += torch.einsum("bkrz,bkr->bkz", cpx, r_p)
        gbar[:, 1:, :nx] += gx_box[:, :n_st - 1]
        gbar[..., nxt:] += tu * (r_uu - r_ul) + torch.einsum(
            "bkrz,bkr->bkz", qp.cpu, r_p)
        gbar[..., nxt + ar_d] += gr
        gbar[..., nx + ar_d] += -gr
        gbar_term = qp.g_term.clone()
        gbar_term[:, :nx] += gx_box[:, n_st - 1]
        return gbar, gbar_term

    def newton(s, lam):
        s_safe = torch.clamp(s, min=1e-10)
        w = lam / s_safe
        w_xu, w_xl, w_uu, w_ul, w_ru, w_rl, w_p = split(w)

        # ---- Hbar: diagonal + two-entry + npc-row contributions
        dxx = tx * tx * (w_xu + w_xl)
        duu = tu * tu * (w_uu + w_ul)
        rr = tr * tr * (w_ru + w_rl)
        cpx_w = cpx * w_p[..., None]
        hbar = qp.h.clone()
        hbar[..., :nx, :nx] += torch.einsum("bkrz,bkrv->bkzv", cpx_w, cpx)
        hxu_p = torch.einsum("bkrz,bkrv->bkzv", cpx_w, qp.cpu)
        hbar[..., :nx, nxt:] += hxu_p
        hbar[..., nxt:, :nx] += hxu_p.transpose(-1, -2)
        hbar[..., nxt:, nxt:] += torch.einsum(
            "bkrz,bkrv->bkzv", qp.cpu * w_p[..., None], qp.cpu)
        hbar[:, 1:, ar_x, ar_x] += dxx[:, :n_st - 1]
        hbar[..., nxt + ar_u, nxt + ar_u] += duu
        hbar[..., nxt + ar_d, nxt + ar_d] += rr
        hbar[..., nx + ar_d, nx + ar_d] += rr
        hbar[..., nxt + ar_d, nx + ar_d] += -rr
        hbar[..., nx + ar_d, nxt + ar_d] += -rr
        hbar_term = qp.h_term.clone()
        hbar_term[:, ar_x, ar_x] += dxx[:, n_st - 1]

        if scheme == "mehrotra":
            k_gains, _, fact = _riccati_backward_s(
                qp, hbar, None, hbar_term, None, with_vectors=False)
            sweep = lambda gb, gt: _riccati_ff_s(qp, fact, k_gains, gb, gt)
        else:
            def sweep(gb, gt):
                k_gains, k_ffs, _ = _riccati_backward_s(qp, hbar, gb,
                                                      hbar_term, gt)
                return _riccati_forward_s(qp, k_gains, k_ffs)

        def solve_rhs(rhs):
            dx_t, du_t = sweep(*gradient(w * (s - d_all) + rhs / s_safe))
            cz = row_dots(dx_t, du_t)
            return (dx_t, du_t, d_all - cz,
                    rhs / s_safe + w * (cz + s - d_all))
        return solve_rhs

    ones = torch.ones(bsz, n_st, nc, dtype=dtype, device=dev)
    s = ones if warm_s is None else rows_to_groups(warm_s, nx).to(dtype)
    lam = ones if warm_lam is None else rows_to_groups(warm_lam, nx).to(dtype)
    mean = lambda v: v.sum((-1, -2)) / m_act
    residual = lambda dx, du, s: torch.abs(row_dots(dx, du) + s
                                           - d_all).amax((-1, -2))
    dx, du, s, lam, it = _newton_loop(
        scheme, max_iter, fixed_iters, qp.e.new_zeros(bsz, n_st + 1, nxt),
        qp.e.new_zeros(bsz, n_st, nu), s, lam, newton, mean, residual)

    mu_fin = mean(s * lam)
    solved = (mu_fin < 10 * EPS_IPM) & (residual(dx, du, s) < 1e-3)
    return IPMSolution(dx_tilde=dx, du=du, lam=groups_to_rows(lam, 0.0, nx),
                       iters=it, solved=solved, mu=mu_fin,
                       s_rows=groups_to_rows(s, 1.0, nx),
                       lam_rows=groups_to_rows(lam, 1.0, nx))
