"""Unrolled small-matrix Cholesky factor and solve, batched over leading
dims (`mpcc_manipulator_tpu/utils/linalg_small.py`).

Same numerical contract as the JAX version: ``sqrt`` is taken directly, so
a non-positive-definite input produces NaNs that propagate into the
Riccati gains, the signal the interior-point divergence guard relies on.
"""

from __future__ import annotations

import torch


def cholesky_small(a: torch.Tensor, n: int) -> torch.Tensor:
    """Lower-triangular Cholesky factor of ``a`` (..., n, n), outer-product
    form; NaN on non-positive-definite input."""
    cols = []
    m = a
    for j in range(n):
        d = torch.sqrt(m[..., 0, 0])
        col = m[..., :, 0] / d[..., None]                # (..., n-j)
        if j:
            pad = torch.zeros(a.shape[:-2] + (j,), dtype=a.dtype,
                              device=a.device)
            col = torch.cat([pad, col], dim=-1)
        cols.append(col)
        if j < n - 1:
            sub = cols[-1][..., j + 1:]
            m = m[..., 1:, 1:] - sub[..., :, None] * sub[..., None, :]
    return torch.stack(cols, dim=-1)


def cho_solve_small(l: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Solve ``A x = b`` given ``l = cholesky_small(A)``; ``b`` is (..., n)
    or (..., n, m)."""
    vec = b.dim() == l.dim() - 1
    if vec:
        b = b[..., None]
    y = []
    r = b
    for i in range(n):
        yi = r[..., 0, :] / l[..., i, i, None]
        y.append(yi)
        if i < n - 1:
            r = r[..., 1:, :] - l[..., i + 1:, i, None] * yi[..., None, :]
    x = [None] * n
    r = torch.stack(y, dim=-2)
    for i in reversed(range(n)):
        xi = r[..., i, :] / l[..., i, i, None]
        x[i] = xi
        if i > 0:
            r = r[..., :i, :] - l[..., i, :i, None] * xi[..., None, :]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def solve_psd_small(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``A^{-1} b`` for PSD ``a`` (..., n, n) via the unrolled factor and
    solve."""
    return cho_solve_small(cholesky_small(a, n), b, n)
