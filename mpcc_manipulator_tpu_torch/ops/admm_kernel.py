"""K5: the OSQP ADMM loop on Ruiz-scaled dense QPs as one CUDA kernel
launch (`csrc/admm.cu`), replacing the TPU kernel `_admm_kernel` of
`mpcc_manipulator_tpu/ops/pallas_admm.py`.

:func:`fused_admm` takes a batch of QPs in the equilibrated space (the
explicit KKT inverse, P, A, q, rho, the bounds, the Ruiz scalings and the
warm iterates x/z/y) and runs ``check_every``-iteration chunks, testing the
unscaled OSQP residuals at entry and after each chunk, each scenario until
it converges or has run ``max_iter`` iterations.  On CUDA tensors it
launches the kernel (or raises); on CPU tensors it runs the plain version,
:func:`fused_admm_plain`; ``interpret=True`` runs that on either device
(`cuda_build.kernel_route`).  Both compute in float32, as the JAX wrapper
casts; nothing is padded (the TPU kernel's 256/512 tiles were a Mosaic
constraint).  The kernel runs one thread block cluster per scenario, with A
and K^-1 split over the cluster's blocks and held on chip for the whole
loop; it takes n <= 192 and m <= 1024 (:func:`launch_config` says how a
shape is launched).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGS = ("kinv", "p", "a", "q", "rho", "l", "u", "dscl", "escl", "cscl",
         "x0", "z0", "y0")


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
    """Plain PyTorch version of K5 (any device), float32.

    Shapes: kinv, p (B, n, n); a (B, m, n); q, dscl, x0 (B, n); rho, l, u,
    escl, z0, y0 (B, m); cscl (B,).  Returns ``(x (B, n), z (B, m),
    y (B, m), it (B,))``: ``it`` counts whole chunks, and is 0 for a warm
    start that already passes the test.
    """
    (kinv, p, a, q, rho, l, u, dscl, escl, cscl, x, z, y) = (
        t.to(torch.float32) for t in (kinv, p, a, q, rho, l, u, dscl, escl,
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


def fused_admm(kinv, p, a, q, rho, l, u, dscl, escl, cscl, x0, z0, y0,
               *, max_iter: int = 400, check_every: int = 25,
               sigma: float = 1e-6, alpha: float = 1.6,
               eps_abs: float = 1e-4, eps_rel: float = 1e-5,
               interpret: bool | None = None):
    """K5 on CUDA (every input float32 and contiguous, shapes as in
    :func:`fused_admm_plain`); the plain version on CPU.  ``interpret``
    names the route (`cuda_build.kernel_route`)."""
    kw = dict(max_iter=max_iter, check_every=check_every, sigma=sigma,
              alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel)
    args = (kinv, p, a, q, rho, l, u, dscl, escl, cscl, x0, z0, y0)
    if cuda_build.kernel_route(interpret, kinv.device,
                               "fused_admm") == "plain":
        return fused_admm_plain(*args, **kw)
    return _launch(0, args, **kw)


def fused_admm_cluster(cluster: int, *args, **kw):
    """K5 on CUDA tensors with ``cluster`` (1, 2, 4 or 8) blocks per
    scenario instead of the smallest cluster that holds the problem, which
    :func:`fused_admm` takes; arguments as there.  A launch counts as
    K5's."""
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"fused_admm_cluster: cluster {cluster} is not "
                         "1, 2, 4 or 8")
    return _launch(cluster, args, **kw)


def _launch(cluster, args, *, max_iter: int = 400, check_every: int = 25,
            sigma: float = 1e-6, alpha: float = 1.6, eps_abs: float = 1e-4,
            eps_rel: float = 1e-5):
    kinv, a = args[0], args[2]
    dev = kinv.device
    cuda_build.require_cuda(dev, "fused_admm")
    if kinv.dim() != 3 or a.dim() != 3:
        raise ValueError("fused_admm: need batched kinv (B, n, n) and "
                         f"a (B, m, n), got {tuple(kinv.shape)}, "
                         f"{tuple(a.shape)}")
    b, n, m = kinv.shape[0], kinv.shape[1], a.shape[1]
    shapes = dict(kinv=(b, n, n), p=(b, n, n), a=(b, m, n), q=(b, n),
                  rho=(b, m), l=(b, m), u=(b, m), dscl=(b, n), escl=(b, m),
                  cscl=(b,), x0=(b, n), z0=(b, m), y0=(b, m))
    for name, t in zip(_ARGS, args):
        cuda_build.check_tensor(f"fused_admm {name}", t, shapes[name], dev)
    if check_every < 1 or max_iter < 0:
        raise ValueError(f"fused_admm: check_every {check_every} must be "
                         f">= 1 and max_iter {max_iter} >= 0")
    x = torch.empty(b, n, dtype=torch.float32, device=dev)
    z = torch.empty(b, m, dtype=torch.float32, device=dev)
    y = torch.empty(b, m, dtype=torch.float32, device=dev)
    it = torch.empty(b, dtype=torch.int32, device=dev)
    entry, asked = (("mpcc_admm_solve_cluster", (int(cluster),)) if cluster
                    else ("mpcc_admm_solve", ()))
    cuda_build.launch(
        "K5", entry, *(t.data_ptr() for t in args), x.data_ptr(),
        z.data_ptr(), y.data_ptr(), it.data_ptr(), b, n, m, int(max_iter),
        int(check_every), *(ctypes.c_float(v) for v in
                             (sigma, alpha, eps_abs, eps_rel)),
        *asked, device=dev,
        detail=f"admm kernel (n={n}, m={m}, cluster {cluster or 'auto'})")
    return x, z, y, it.long()

_LAUNCH_FIELDS = ("cluster", "smem_bytes", "threads", "active_clusters",
                 "registers", "local_bytes")


def launch_config(n: int, m: int, cluster: int = 0) -> dict:
    """How K5 launches an (n, m) problem on the current card: the cluster
    size, dynamic shared memory per block, threads per block, clusters the
    card holds at once, and the kernel's registers and local-memory bytes
    (stack and spills) per thread.  Raises where no cluster size holds the problem."""
    return cuda_build.launch_config("mpcc_admm_launch_config",
                                    _LAUNCH_FIELDS, n, m, cluster)
