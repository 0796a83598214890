"""Franka Panda forward kinematics, Jacobian and manipulability, batched
over leading dims (`mpcc_manipulator_tpu/models/kinematics.py`).

Each joint i contributes a fixed parent<-child transform
``(R_off[i], p_off[i])`` followed by ``Rz(q_i)``; after joint 7 a fixed
flange->hand->TCP transform gives the end-effector frame.  The constant
tables below are also the data the K4 CUDA kernel reads
(:func:`kinematics_constants`), so they are written down once.

The manipulability gradient comes in the JAX package's three variants:
the analytic closed form (a dJ/dq cross-product tensor and one damped 6x6
Cholesky solve; the K4 route and the bench configuration), the reference's
central finite difference and the exact autodiff gradient (the plain
RobotData route, ``kin_backend="xla"``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PANDA_DOF

_RX_P90 = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])   # Rx(+pi/2)
_RX_M90 = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])   # Rx(-pi/2)
_EYE = np.eye(3)

_R_OFF = np.stack([_EYE, _RX_M90, _RX_P90, _RX_P90, _RX_M90, _RX_P90,
                   _RX_P90])
_P_OFF = np.array([
    [0.0, 0.0, 0.333],
    [0.0, 0.0, 0.0],
    [0.0, -0.316, 0.0],
    [0.0825, 0.0, 0.0],
    [-0.0825, 0.384, 0.0],
    [0.0, 0.0, 0.0],
    [0.088, 0.0, 0.0],
])

# flange -> hand: Rz(-45 deg), 0.107 along z; hand -> TCP: +0.1034 z
_C45 = math.sqrt(0.5)
_R_HAND = np.array([[_C45, _C45, 0.0], [-_C45, _C45, 0.0], [0.0, 0.0, 1.0]])
_P_HAND = np.array([0.0, 0.0, 0.107])
_P_TCP = np.array([0.0, 0.0, 0.1034])
_R_POST = _R_HAND
_P_POST = _P_HAND + _R_HAND @ _P_TCP


def kinematics_constants() -> np.ndarray:
    """The joint offset tables as one flat float64 buffer of 96 values:
    ``R_off (7,3,3) | p_off (7,3) | R_post (3,3) | p_post (3)``, row-major
    (the layout the K4 kernel reads)."""
    return np.concatenate([_R_OFF.reshape(-1), _P_OFF.reshape(-1),
                           _R_POST.reshape(-1), _P_POST.reshape(-1)])


def _rz(q):
    c, s = torch.cos(q), torch.sin(q)
    z = torch.zeros_like(q)
    o = torch.ones_like(q)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def fk_chain(q: torch.Tensor):
    """Full chain FK for q (..., 7).

    Returns ``(p_ee (...,3), r_ee (...,3,3), origins (...,7,3),
    axes (...,7,3))``: world joint origins and joint axes for the Jacobian.
    """
    kw = dict(dtype=q.dtype, device=q.device)
    r = torch.eye(3, **kw).expand(q.shape[:-1] + (3, 3))
    p = torch.zeros(q.shape[:-1] + (3,), **kw)
    r_off = torch.tensor(_R_OFF, **kw)
    p_off = torch.tensor(_P_OFF, **kw)
    origins, axes = [], []
    for i in range(PANDA_DOF):
        p = p + r @ p_off[i]
        r_fixed = r @ r_off[i]
        origins.append(p)
        axes.append(r_fixed[..., :, 2])
        r = r_fixed @ _rz(q[..., i])
    p_ee = p + r @ torch.tensor(_P_POST, **kw)
    r_ee = r @ torch.tensor(_R_POST, **kw)
    return p_ee, r_ee, torch.stack(origins, -2), torch.stack(axes, -2)


def ee_position(q: torch.Tensor) -> torch.Tensor:
    """End-effector (hand TCP) position, world frame."""
    return fk_chain(q)[0]


def ee_orientation(q: torch.Tensor) -> torch.Tensor:
    """End-effector rotation matrix, world frame."""
    return fk_chain(q)[1]


def ee_position_host(q) -> np.ndarray:
    """:func:`ee_position` of host data (numpy / a list, (..., 7)) on the
    CPU, returned as numpy in the input's dtype: setup paths (track
    shifting, the API entry) read the EE position on the host without a
    device round trip."""
    return ee_position(torch.as_tensor(np.asarray(q))).numpy()


def ee_orientation_host(q) -> np.ndarray:
    """:func:`ee_orientation` of host data on the CPU, as numpy."""
    return ee_orientation(torch.as_tensor(np.asarray(q))).numpy()


def ee_jacobian(q: torch.Tensor) -> torch.Tensor:
    """(..., 6, 7) point Jacobian ``[Jv; Jw]`` of the TCP."""
    p_ee, _, origins, axes = fk_chain(q)
    jv = torch.linalg.cross(axes, p_ee[..., None, :] - origins).transpose(-1, -2)
    return torch.cat([jv, axes.transpose(-1, -2)], dim=-2)


def _det_psd6(a: torch.Tensor) -> torch.Tensor:
    """Determinant of a 6x6 symmetric PSD matrix by the clamped-pivot
    elimination; 0 for singular input."""
    det = torch.ones_like(a[..., 0, 0])
    m = a
    for i in range(6):
        pivot = m[..., 0, 0]
        det = det * pivot
        safe = torch.where(pivot > 1e-30, pivot, torch.ones_like(pivot))
        if i < 5:
            col = m[..., 1:, 0]
            m = (m[..., 1:, 1:]
                 - col[..., :, None] * col[..., None, :] / safe[..., None, None])
    return torch.clamp(det, min=0.0)


def manipulability(q: torch.Tensor) -> torch.Tensor:
    """Yoshikawa manipulability ``sqrt(det(J J'))`` of the 6x7 TCP
    Jacobian, q (..., 7) -> (...)."""
    j = ee_jacobian(q)
    return torch.sqrt(_det_psd6(j @ j.transpose(-1, -2)))


def _cholesky6(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a 6x6 PD matrix with a trace-scaled Tikhonov shift
    and a dtype-relative pivot floor (keeps the gradient finite near a
    kinematic singularity in float32)."""
    n = 6
    eps = torch.finfo(a.dtype).eps
    scale = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / n + eps
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    m = a + (10.0 * eps * scale)[..., None, None] * eye
    floor = eps * scale
    head = torch.arange(n, device=a.device)
    cols = []
    for j in range(n):
        dgj = torch.sqrt(torch.maximum(m[..., j, j], floor))
        col = torch.where(head < j, torch.zeros_like(m[..., :, j]),
                          m[..., :, j]) / dgj[..., None]
        cols.append(col)
        if j < n - 1:
            m = m - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def _cho_solve6(l_mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = rhs for 6x6 lower L, rhs (..., 6, k)."""
    n = 6
    ys = []
    for i in range(n):
        acc = rhs[..., i, :]
        for j in range(i):
            acc = acc - l_mat[..., i, j, None] * ys[j]
        ys.append(acc / l_mat[..., i, i, None])
    xs = [None] * n
    for i in reversed(range(n)):
        acc = ys[i]
        for j in range(i + 1, n):
            acc = acc - l_mat[..., j, i, None] * xs[j]
        xs[i] = acc / l_mat[..., i, i, None]
    return torch.stack(xs, dim=-2)


def jacobian_derivative(p_ee: torch.Tensor, origins: torch.Tensor,
                        axes: torch.Tensor) -> torch.Tensor:
    """Closed-form dJ/dq of the 6x7 point Jacobian: (..., 7, 6, 7), entry
    ``[i, :, j] = d(J column j)/dq_i``:

      d(Jv_j)/dq_i = (z_i x z_j) x (p_e - p_j) + z_j x (z_i x (p_e - p_j))  (i < j)
                   = z_j x Jv_i                                             (i >= j)
      d(Jw_j)/dq_i = z_i x z_j  (i < j, else 0)
    """
    dof = axes.shape[-2]
    cross = torch.linalg.cross                         # broadcasts
    re = p_ee[..., None, :] - origins                  # (..., j, 3)
    jv_cols = cross(axes, re)
    z_i = axes[..., :, None, :]                        # (..., i, 1, 3)
    z_j = axes[..., None, :, :]                        # (..., 1, j, 3)
    re_j = re[..., None, :, :]
    zixzj = cross(z_i, z_j)                            # (..., i, j, 3)
    ar = torch.arange(dof, device=axes.device)
    lt = (ar[:, None] < ar[None, :])[..., None]
    djv_lt = cross(zixzj, re_j) + cross(z_j, cross(z_i, re_j))
    djv_ge = cross(z_j, jv_cols[..., :, None, :])      # z_j x Jv_i
    djv = torch.where(lt, djv_lt, djv_ge)
    djw = torch.where(lt, zixzj, torch.zeros_like(zixzj))
    return torch.cat([djv.transpose(-1, -2), djw.transpose(-1, -2)], dim=-2)


def manipulability_and_grad_from_frames(p_ee: torch.Tensor,
                                        origins: torch.Tensor,
                                        axes: torch.Tensor):
    """(m, dm/dq) from an FK pass:
    ``dm/dq_i = m sum_{b,c} dJ_i[b, c] (A^-1 J)[b, c]`` with ``A = J J'``."""
    jv = torch.linalg.cross(axes, p_ee[..., None, :] - origins)
    j = torch.cat([jv, axes], dim=-1).transpose(-1, -2)      # (..., 6, 7)
    a = j @ j.transpose(-1, -2)
    m = torch.sqrt(_det_psd6(a))
    dj = jacobian_derivative(p_ee, origins, axes)
    ainv_j = _cho_solve6(_cholesky6(a), j)
    dm = m[..., None] * torch.einsum("...ibc,...bc->...i", dj, ainv_j)
    return m, dm
