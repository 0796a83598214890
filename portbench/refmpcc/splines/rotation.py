"""SO(3) cubic "ease" spline on the rotation manifold
(`mpcc_manipulator_tpu/splines/rotation.py`).

Per segment ``R(t) = R_i Exp(omega_i (c dx^2 + d dx^3))`` with
``c = 3/h^2``, ``d = -2/h^3``; the segment logs ``omega_i`` are computed once
on the host at fit time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import so3


def _np_log_rot_vec(r: np.ndarray) -> np.ndarray:
    """Host (numpy, float64) rotation log for fit-time precomputation."""
    tr = np.trace(r)
    if abs(tr + 1.0) < 1e-6:
        # angle ~ pi: axis from the symmetric part; reference convention
        # omega = -axis * pi
        w, v = np.linalg.eigh((r + r.T) / 2.0)
        axis = v[:, np.argmax(w)]
        axis = axis / np.linalg.norm(axis)
        return -axis * np.pi
    if abs(tr - 3.0) < 1e-6:
        return np.zeros(3)
    th = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    m = th / (2.0 * np.sin(th)) * (r - r.T)
    return np.array([m[2, 1], m[0, 2], m[1, 0]])


@dataclasses.dataclass
class RotSplineCoeffs:
    """Regular-knot SO(3) spline on the device."""

    delta: torch.Tensor   # knot spacing
    length: torch.Tensor  # parameter of the last knot
    r: torch.Tensor       # (n, 3, 3) knot rotations
    omega: torch.Tensor   # (n-1, 3) log(R_i^T R_{i+1})
    c: torch.Tensor       # (n-1,) = 3/h^2
    d: torch.Tensor       # (n-1,) = -2/h^3

    @classmethod
    def from_knots(cls, x: np.ndarray, rotations: np.ndarray,
                   dtype=torch.float64, device="cuda"):
        x = np.asarray(x, dtype=np.float64)
        rotations = np.asarray(rotations, dtype=np.float64)
        h = np.diff(x)
        omega = np.stack([_np_log_rot_vec(rotations[i].T @ rotations[i + 1])
                          for i in range(x.size - 1)])
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return cls(delta=t(float(x[1] - x[0])), length=t(float(x[-1])),
                   r=t(rotations), omega=t(omega), c=t(3.0 / h ** 2),
                   d=t(-2.0 / h ** 3))


def _segment(sp: RotSplineCoeffs, s):
    s = torch.minimum(torch.clamp(s, min=0.0), sp.length)
    n = sp.r.shape[0]
    idx = torch.clamp(torch.floor(s / sp.delta).long(), 0, n - 2)
    dx = s - idx.to(s.dtype) * sp.delta
    return s, idx, dx


def rot_spline_value(sp: RotSplineCoeffs, s) -> torch.Tensor:
    """R(s) (..., 3, 3); at the endpoint the final knot rotation exactly."""
    s, i, dx = _segment(sp, s)
    blend = sp.c[i] * dx * dx + sp.d[i] * dx * dx * dx
    r_val = sp.r[i] @ so3.exp_rot(sp.omega[i] * blend[..., None])
    return torch.where((s >= sp.length)[..., None, None], sp.r[-1], r_val)


def rot_spline_derivative(sp: RotSplineCoeffs, s) -> torch.Tensor:
    """dR/ds as the angular-velocity vector (..., 3); 0 at the endpoint."""
    s, i, dx = _segment(sp, s)
    dblend = 2.0 * sp.c[i] * dx + 3.0 * sp.d[i] * dx * dx
    der = sp.omega[i] * dblend[..., None]
    return torch.where((s >= sp.length)[..., None], torch.zeros_like(der), der)
