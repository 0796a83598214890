"""Natural cubic splines: host-side numpy fit, batched device evaluation
(`mpcc_manipulator_tpu/splines/cubic.py`).

Endpoint semantics replicate the reference: at ``x == x_max`` the value is
``y[-1]``, the first derivative is 0 and the second derivative ``2*c[-1]``.
Evaluation is an indexed gather plus a polynomial; ``s`` may have any shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def fit_natural_cubic(x: np.ndarray, y: np.ndarray):
    """Fit a natural cubic spline through ``(x, y)``; returns per-knot
    (a, b, c, d) with ``y(t) = a_i + b_i dx + c_i dx^2 + d_i dx^3``."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.size
    a = y.copy()
    b = np.zeros(n)
    c = np.zeros(n)
    d = np.zeros(n)
    h = np.diff(x)
    alpha = np.zeros(n)
    alpha[1:n - 1] = (3.0 / h[1:] * (a[2:] - a[1:n - 1])
                      - 3.0 / h[:-1] * (a[1:n - 1] - a[:n - 2]))
    l = np.ones(n)
    mu = np.zeros(n)
    z = np.zeros(n)
    for i in range(1, n - 1):
        l[i] = 2.0 * (x[i + 1] - x[i - 1]) - h[i - 1] * mu[i - 1]
        mu[i] = h[i] / l[i]
        z[i] = (alpha[i] - h[i - 1] * z[i - 1]) / l[i]
    for i in range(n - 2, -1, -1):
        c[i] = z[i] - mu[i] * c[i + 1]
        b[i] = (a[i + 1] - a[i]) / h[i] - h[i] * (c[i + 1] + 2.0 * c[i]) / 3.0
        d[i] = (c[i + 1] - c[i]) / (3.0 * h[i])
    return a, b, c, d


class HostCubicSpline:
    """Host-side (numpy) spline over arbitrary knots, used only by the
    one-time track fit pipeline."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x = np.asarray(x, dtype=np.float64)
        self.a, self.b, self.c, self.d = fit_natural_cubic(x, y)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        t = np.clip(t, self.x[0], self.x[-1])
        i = np.clip(np.searchsorted(self.x, t, side="right") - 1,
                    0, self.x.size - 2)
        dx = t - self.x[i]
        return (self.a[i] + self.b[i] * dx + self.c[i] * dx ** 2
                + self.d[i] * dx ** 3)


@dataclasses.dataclass
class CubicSplineCoeffs:
    """Regular-knot cubic spline (one scalar channel) on the device."""

    delta: torch.Tensor   # knot spacing
    length: torch.Tensor  # x of the last knot (x starts at 0)
    a: torch.Tensor       # (n,)
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor

    @classmethod
    def from_fit(cls, x: np.ndarray, y: np.ndarray, dtype=torch.float64,
                 device="cuda"):
        a, b, c, d = fit_natural_cubic(x, y)
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return cls(delta=t(float(x[1] - x[0])), length=t(float(x[-1])),
                   a=t(a), b=t(b), c=t(c), d=t(d))


def _segment(sp: CubicSplineCoeffs, s):
    """Clamped input, segment index, and local offset dx."""
    s = torch.minimum(torch.clamp(s, min=0.0), sp.length)
    n = sp.a.shape[0]
    idx = torch.clamp(torch.floor(s / sp.delta).long(), 0, n - 2)
    dx = s - idx.to(s.dtype) * sp.delta
    return s, idx, dx


def spline_value(sp: CubicSplineCoeffs, s):
    s, i, dx = _segment(sp, s)
    val = sp.a[i] + sp.b[i] * dx + sp.c[i] * dx * dx + sp.d[i] * dx * dx * dx
    return torch.where(s >= sp.length, sp.a[-1], val)


def spline_derivative(sp: CubicSplineCoeffs, s):
    s, i, dx = _segment(sp, s)
    der = sp.b[i] + 2.0 * sp.c[i] * dx + 3.0 * sp.d[i] * dx * dx
    return torch.where(s >= sp.length, torch.zeros_like(der), der)


def spline_second_derivative(sp: CubicSplineCoeffs, s):
    s, i, dx = _segment(sp, s)
    sec = 2.0 * sp.c[i] + 6.0 * sp.d[i] * dx
    return torch.where(s >= sp.length, 2.0 * sp.c[-1], sec)
