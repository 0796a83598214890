"""The OSQP ADMM loop on Ruiz-scaled dense QPs, plain PyTorch: the
chunked loop of the port's K5 (`ops/admm_kernel.fused_admm_plain`), in the
dtype of its inputs.  Each scenario runs ``check_every``-iteration chunks,
testing the unscaled OSQP residuals at entry and after each chunk, until it
converges or has run ``max_iter`` iterations.
"""

from __future__ import annotations

import torch

def mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``mat @ v``."""
    return (mat @ v[..., None])[..., 0]


def vm(v: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Batched ``v' mat`` (the TPU kernel's row-vector products)."""
    return (v[..., None, :] @ mat)[..., 0, :]


def fused_admm_plain(kinv, p, a, q, rho, l, u, dscl, escl, cscl, x0, z0, y0,
                     *, max_iter: int = 400, check_every: int = 25,
                     sigma: float = 1e-6, alpha: float = 1.6,
                     eps_abs: float = 1e-4, eps_rel: float = 1e-5):
    """The K5 loop in the dtype of ``kinv``.

    Shapes: kinv, p (B, n, n); a (B, m, n); q, dscl, x0 (B, n); rho, l, u,
    escl, z0, y0 (B, m); cscl (B,).  Returns ``(x (B, n), z (B, m),
    y (B, m), it (B,))``: ``it`` counts whole chunks, and is 0 for a warm
    start that already passes the test.
    """
    (kinv, p, a, q, rho, l, u, dscl, escl, cscl, x, z, y) = (
        t.to(kinv.dtype) for t in (kinv, p, a, q, rho, l, u, dscl, escl,
                                      cscl, x0, z0, y0))
    inv_rho = 1.0 / rho
    cscl = cscl[:, None]
    q_abs_d = (dscl * q).abs().amax(-1, keepdim=True)

    def converged(x, z, y):
        ax, px, aty = mv(a, x), vm(x, p), vm(y, a)
        r_prim = ((ax - z) / escl).abs().amax(-1)
        r_dual = (dscl * (px + q + aty) / cscl).abs().amax(-1)
        s_prim = torch.maximum((ax / escl).abs().amax(-1),
                               (z / escl).abs().amax(-1))
        s_dual = torch.maximum(torch.maximum(
            (dscl * px).abs().amax(-1, keepdim=True),
            (dscl * aty).abs().amax(-1, keepdim=True)), q_abs_d) / cscl
        return ((r_prim <= eps_abs + eps_rel * s_prim)
                & (r_dual <= eps_abs + eps_rel * s_dual[:, 0]))

    done = converged(x, z, y)
    it = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    while True:
        active = ~done & (it < max_iter)
        if not bool(active.any()):
            break
        xn, zn, yn = x, z, y
        for _ in range(check_every):
            rhs = sigma * xn - q + vm(rho * zn - yn, a)
            xn = vm(rhs, kinv)
            z_relax = alpha * mv(a, xn) + (1.0 - alpha) * zn
            z1 = torch.minimum(torch.maximum(z_relax + yn * inv_rho, l), u)
            yn = yn + rho * (z_relax - z1)
            zn = z1
        act = active[:, None]
        x = torch.where(act, xn, x)
        z = torch.where(act, zn, z)
        y = torch.where(act, yn, y)
        it = torch.where(active, it + check_every, it)
        done = torch.where(active, converged(x, z, y), done)
    return x, z, y, it
