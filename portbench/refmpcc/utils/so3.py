"""SO(3) primitives, batched over leading dims (`mpcc_manipulator_tpu/utils/so3.py`).

hat/vee, Log (three branches), Exp (Rodrigues), both right-Jacobian
inverse variants (the exact one and the reference implementation's sign
variant, the default, ``exact_heading_jac=False``), and the quaternion
conversions.  Branches are
``torch.where`` selections with NaN-safe arguments, as in the JAX version.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat` (reads the lower-triangular components)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def log_rot(r: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm of a rotation (..., 3, 3), returned as a skew matrix.

    Identity (theta ~ 0), generic, and theta ~ pi branches; the pi branch
    takes the axis from the diagonal with signs from the off-diagonal sums
    anchored at the largest component.
    """
    rt = r.transpose(-1, -2)
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_th = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    th = torch.atan2(torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0)),
                     cos_th)

    sin_th = torch.sin(th)
    safe_sin = torch.where(torch.abs(sin_th) < _EPS, torch.ones_like(sin_th),
                           sin_th)
    generic = (0.5 * th / safe_sin)[..., None, None] * (r - rt)
    near_id = 0.5 * (r - rt)

    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    a_abs = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, min=0.0))
    k = torch.argmax(a_abs, dim=-1)                          # (...,)
    kk = k[..., None, None]
    row_k = torch.gather(r, -2, kk.expand(*k.shape, 1, 3))[..., 0, :]
    col_k = torch.gather(r, -1, kk.expand(*k.shape, 3, 1))[..., 0]
    is_k = torch.arange(3, device=r.device) == k[..., None]
    signs = torch.sign(torch.where(is_k, torch.ones_like(diag),
                                   (row_k + col_k) / 2.0))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    axis = a_abs * signs
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1),
                              min=_EPS)[..., None]
    near_pi = hat(axis * th[..., None])

    out = torch.where((th < 1e-6)[..., None, None], near_id, generic)
    return torch.where((math.pi - th < 1e-4)[..., None, None], near_pi, out)


def log_rot_vec(r: torch.Tensor) -> torch.Tensor:
    """Rotation-vector (axis*angle) logarithm: ``vee(log_rot(R))``."""
    return vee(log_rot(r))


def exp_rot(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential of rotation vectors (..., 3) -> (..., 3, 3)."""
    th2 = _dot(omega, omega)
    th = torch.sqrt(th2)
    k = hat(omega)
    k2 = k @ k
    small = th < _EPS
    safe_th = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe_th) / safe_th)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(safe_th)) / (safe_th * safe_th))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a[..., None, None] * k + b[..., None, None] * k2


def _jr_inv_with_coef(phi: torch.Tensor, sign: float) -> torch.Tensor:
    n2 = _dot(phi, phi)
    n = torch.sqrt(n2)
    k = hat(phi)
    small = n < _EPS
    safe_n = torch.where(small, torch.ones_like(n), n)
    safe_n2 = torch.where(small, torch.ones_like(n2), n2)
    sin_n = torch.sin(safe_n)
    safe_sin = torch.where(torch.abs(sin_n) < _EPS, torch.ones_like(sin_n),
                           sin_n)
    coef = 1.0 / safe_n2 + sign * (1.0 + torch.cos(safe_n)) / (
        2.0 * safe_n * safe_sin)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    jr_inv = eye + 0.5 * k + coef[..., None, None] * (k @ k)
    return torch.where(small[..., None, None], eye.expand_as(jr_inv), jr_inv)


def right_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """Exact inverse of the SO(3) right Jacobian at rotation vector ``phi``:
    ``I + 1/2 hat(phi) + (1/th^2 - (1+cos th)/(2 th sin th)) hat(phi)^2``."""
    return _jr_inv_with_coef(phi, -1.0)


def right_jacobian_inverse_ref(phi: torch.Tensor) -> torch.Tensor:
    """The reference implementation's variant (``+`` where the exact formula
    has ``-``), kept for trajectory conformance with the C++ engine."""
    return _jr_inv_with_coef(phi, +1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (x, y, z, w) (..., 4), normalized first -> rotation
    matrices (..., 3, 3)."""
    x, y, z, w = (q / torch.linalg.vector_norm(q, dim=-1,
                                               keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)
