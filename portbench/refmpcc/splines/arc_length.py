"""6-D arc-length-parameterized track spline: fit, evaluation, projection
(`mpcc_manipulator_tpu/splines/arc_length.py`).

The double-pass fit runs once on the host in float64 numpy; evaluation is
batched over any leading shape of ``s``; :func:`project_on_spline` is the
masked-argmin fallback plus a fixed 20-iteration Newton refinement with the
reference's early-exit and give-back-the-guess semantics, per lane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import N_SPLINE
from .cubic import (CubicSplineCoeffs, HostCubicSpline, spline_derivative,
                    spline_second_derivative, spline_value)
from .rotation import (RotSplineCoeffs, _np_log_rot_vec, rot_spline_derivative,
                       rot_spline_value)


@dataclasses.dataclass
class TrackSpline:
    """Three position channels + SO(3) channel + resampled waypoints."""

    sx: CubicSplineCoeffs
    sy: CubicSplineCoeffs
    sz: CubicSplineCoeffs
    sr: RotSplineCoeffs
    wp: torch.Tensor       # (N_SPLINE, 3) resampled waypoints
    s_knots: torch.Tensor  # (N_SPLINE,)
    length: torch.Tensor   # total arc length


# ------------------------------------------------------------------
# Fit pipeline (host, float64)
# ------------------------------------------------------------------


def _chord_length(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    d = np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2 + np.diff(z) ** 2)
    return np.concatenate([[0.0], np.cumsum(d)])


class _HostRotSpline:
    """Host-side SO(3) ease spline over irregular knots (fit pipeline only)."""

    def __init__(self, s: np.ndarray, rotations: np.ndarray):
        self.s = np.asarray(s, dtype=np.float64)
        self.r = np.asarray(rotations, dtype=np.float64)
        h = np.diff(self.s)
        self.c = 3.0 / h ** 2
        self.d = -2.0 / h ** 3
        self.omega = np.stack([_np_log_rot_vec(self.r[i].T @ self.r[i + 1])
                               for i in range(len(h))])

    def __call__(self, t: float) -> np.ndarray:
        t = float(np.clip(t, self.s[0], self.s[-1]))
        if t >= self.s[-1]:
            return self.r[-1]
        i = int(np.clip(np.searchsorted(self.s, t, side="right") - 1,
                        0, len(self.c) - 1))
        dx = t - self.s[i]
        w = self.omega[i] * (self.c[i] * dx ** 2 + self.d[i] * dx ** 3)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if th < 1e-12:
            e = np.eye(3) + k
        else:
            e = (np.eye(3) + np.sin(th) / th * k
                 + (1 - np.cos(th)) / th ** 2 * (k @ k))
        return self.r[i] @ e


def _resample(sx, sy, sz, sr, total_len: float, n: int):
    s_new = np.linspace(0.0, total_len, n)
    return (s_new, sx(s_new), sy(s_new), sz(s_new),
            np.stack([sr(si) for si in s_new]))


def gen_6d_spline(x, y, z, rotations, dtype=torch.float64,
                  device="cuda") -> TrackSpline:
    """Double-pass fit: fit -> resample -> refit -> resample -> final
    regular-knot spline on ``device``."""
    x, y, z = (np.asarray(v, dtype=np.float64) for v in (x, y, z))
    rotations = np.asarray(rotations, dtype=np.float64)

    s1 = _chord_length(x, y, z)
    _, x1, y1, z1, r1 = _resample(
        HostCubicSpline(s1, x), HostCubicSpline(s1, y), HostCubicSpline(s1, z),
        _HostRotSpline(s1, rotations), float(s1[-1]), N_SPLINE)

    s2 = _chord_length(x1, y1, z1)
    s_reg, x2, y2, z2, r2 = _resample(
        HostCubicSpline(s2, x1), HostCubicSpline(s2, y1),
        HostCubicSpline(s2, z1), _HostRotSpline(s2, r1), float(s2[-1]),
        N_SPLINE)

    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return TrackSpline(
        sx=CubicSplineCoeffs.from_fit(s_reg, x2, dtype, device),
        sy=CubicSplineCoeffs.from_fit(s_reg, y2, dtype, device),
        sz=CubicSplineCoeffs.from_fit(s_reg, z2, dtype, device),
        sr=RotSplineCoeffs.from_knots(s_reg, r2, dtype, device),
        wp=t(np.stack([x2, y2, z2], axis=1)),
        s_knots=t(s_reg),
        length=t(float(s_reg[-1])),
    )


def shift_track_to(x, y, z, position):
    """Translate the path so it starts at ``position``."""
    return (x - x[0] + position[0], y - y[0] + position[1],
            z - z[0] + position[2])


# ------------------------------------------------------------------
# Device evaluation: s (...) -> (..., 3) / (..., 3, 3)
# ------------------------------------------------------------------


def track_position(tr: TrackSpline, s) -> torch.Tensor:
    return torch.stack([spline_value(tr.sx, s), spline_value(tr.sy, s),
                        spline_value(tr.sz, s)], dim=-1)


def track_derivative(tr: TrackSpline, s) -> torch.Tensor:
    return torch.stack([spline_derivative(tr.sx, s),
                        spline_derivative(tr.sy, s),
                        spline_derivative(tr.sz, s)], dim=-1)


def track_second_derivative(tr: TrackSpline, s) -> torch.Tensor:
    return torch.stack([spline_second_derivative(tr.sx, s),
                        spline_second_derivative(tr.sy, s),
                        spline_second_derivative(tr.sz, s)], dim=-1)


def track_orientation(tr: TrackSpline, s) -> torch.Tensor:
    return rot_spline_value(tr.sr, s)


def track_orientation_derivative(tr: TrackSpline, s) -> torch.Tensor:
    return rot_spline_derivative(tr.sr, s)


# ------------------------------------------------------------------
# Projection
# ------------------------------------------------------------------


def project_on_spline(tr: TrackSpline, s_guess, ee_pos,
                      max_dist_proj) -> torch.Tensor:
    """Arc-length projection of ``ee_pos`` (B, 3) near ``s_guess`` (B,).

    * if the current-point distance exceeds ``max_dist_proj``, restart from
      the nearest resampled waypoint whose ``|s - s_guess| <= max_dist_proj``
      (global nearest waypoint if none qualifies);
    * if the restart point is the track end, return the track end;
    * otherwise refine with up to 20 Newton steps on ``||p(s) - ee||^2``,
      keeping the first step change ``<= 1e-5`` and returning the original
      guess if no step converges.
    """
    pos0 = track_position(tr, s_guess)
    dist0 = torch.linalg.vector_norm(ee_pos - pos0, dim=-1)

    d2 = ((tr.wp[None] - ee_pos[:, None, :]) ** 2).sum(-1)      # (B, n)
    valid = torch.abs(tr.s_knots[None] - s_guess[:, None]) <= max_dist_proj
    masked = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    s_masked = tr.s_knots[torch.argmin(masked, dim=-1)]
    s_global = tr.s_knots[torch.argmin(d2, dim=-1)]
    s_fallback = torch.where(valid.any(-1), s_masked, s_global)
    s_opt0 = torch.where(dist0 >= max_dist_proj, s_fallback, s_guess)
    at_end = s_opt0 >= tr.length

    s_cur = s_opt0
    s_result = s_opt0
    converged = torch.zeros_like(s_guess, dtype=torch.bool)
    for _ in range(20):
        p = track_position(tr, s_cur)
        dp = track_derivative(tr, s_cur)
        ddp = track_second_derivative(tr, s_cur)
        diff = p - ee_pos
        jac = 2.0 * (diff * dp).sum(-1)
        hess = 2.0 * (dp * dp).sum(-1) + 2.0 * (diff * ddp).sum(-1)
        s_new = torch.minimum(torch.clamp(s_cur - jac / hess, min=0.0),
                              tr.length)
        step_converged = torch.abs(s_cur - s_new) <= 1e-5
        newly = ~converged & step_converged
        s_result = torch.where(newly, s_new, s_result)
        converged = converged | step_converged
        s_cur = torch.where(converged, s_cur, s_new)
    s_newton = torch.where(converged, s_result, s_guess)
    return torch.where(at_end, tr.length, s_newton)
