"""Learned collision-distance models: MLP forward + input Jacobian
(`mpcc_manipulator_tpu/models/collision_nn.py`).

* self-collision: q (7,) -> min link-link distance [cm], 21->256->64->1;
* env-collision: [q (7,), obs_pos (3,)] -> per-link distance [cm] (9),
  30->256x4->9;

both with the "NeRF" input encoding ``[x, sin x, cos x]``.  The Jacobian is
accumulated from the output side (both nets have fewer outputs than encoded
inputs), ``J <- (J * relu'(z_l)) @ W_l`` with ReLU' taken as ``z > 0``; the
batched products are plain ``torch`` matmuls.

``mm_dtype="bfloat16"`` (``SQPConfig.nn_bf16``) runs the forward-and-
Jacobian pass's GEMMs as JAX's ``_mm`` does: both operands rounded to
bf16, the product accumulated in float32, then cast to the pipeline dtype.
On the card that is one ``torch.mm(..., out_dtype=torch.float32)`` on bf16
operands (cuBLAS, bf16 tensor cores, float32 result); on the CPU the
rounded operands are multiplied in float32 (the products of bf16 values
are exact there, so the two differ in summation order only).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..config import PANDA_DOF, PANDA_NUM_LINKS

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
_ASSET_NN_DIR = os.path.join(_REPO_ROOT, "assets", "nn")

SELF_HIDDEN = (256, 64)
ENV_HIDDEN = (256, 256, 256, 256)


def nerf_encode(x: torch.Tensor) -> torch.Tensor:
    """``[x, sin x, cos x]`` encoding."""
    return torch.cat([x, torch.sin(x), torch.cos(x)], dim=-1)


class CollisionMLP(nn.Module):
    """A ReLU MLP with NeRF-encoded input; weights are (out, in) as in the
    reference parameter files."""

    def __init__(self, weights, biases, dtype=torch.float64, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList()
        for w, b in zip(weights, biases):
            w = np.asarray(w)
            lin = nn.Linear(w.shape[1], w.shape[0], dtype=dtype, device=device)
            lin.weight.requires_grad_(False).copy_(torch.tensor(w))
            lin.bias.requires_grad_(False).copy_(torch.tensor(np.asarray(b)))
            self.layers.append(lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Values only: x (..., n_in) -> (..., n_out)."""
        return mlp_forward(self, x)


def mlp_forward(net: CollisionMLP, x: torch.Tensor,
                is_nerf: bool = True) -> torch.Tensor:
    """Value-only forward pass, x (..., n_in) -> (..., n_out); with
    ``is_nerf=False`` the input goes to the first layer unencoded."""
    h = nerf_encode(x) if is_nerf else x
    for lin in net.layers[:-1]:
        h = torch.relu(lin(h))
    return net.layers[-1](h)


MM_DTYPES = (None, "bfloat16")


def _mm(a: torch.Tensor, b: torch.Tensor, mm_dtype) -> torch.Tensor:
    """``a @ b`` for 2-D ``a``, ``b``; with ``mm_dtype="bfloat16"`` on bf16
    operands with a float32 product, cast back to ``a``'s dtype."""
    if mm_dtype is None:
        return a @ b
    bf16 = torch.bfloat16
    if a.is_cuda:
        out = torch.mm(a.to(bf16), b.to(bf16), out_dtype=torch.float32)
    else:
        out = a.to(bf16).float() @ b.to(bf16).float()
    return out.to(a.dtype)


def mlp_forward_jacobian(net: CollisionMLP, x: torch.Tensor, mm_dtype=None,
                         *, is_nerf: bool = True):
    """Forward pass + analytic input Jacobian.

    ``x`` (B, n_in) -> ``(y (B, n_out), dy/dx (B, n_out, n_in))``;
    ``mm_dtype``: ``None`` (the pipeline dtype) or ``"bfloat16"``; with
    ``is_nerf=False`` the input goes to the first layer unencoded.
    ``is_nerf`` is keyword-only: JAX's third positional parameter is
    ``is_nerf``, the port's ``mm_dtype``, and a bool there raises.
    """
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype {mm_dtype!r}: expected one of "
                         f"{MM_DTYPES}")
    h = nerf_encode(x) if is_nerf else x
    last = net.layers[-1]
    if last.out_features >= h.shape[-1]:
        raise ValueError("output-side Jacobian accumulation needs fewer "
                         "outputs than encoded inputs")
    if mm_dtype is None:
        linear = lambda lin, h: lin(h)
    else:
        linear = lambda lin, h: _mm(h, lin.weight.T, mm_dtype) + lin.bias
    masks = []
    for lin in net.layers[:-1]:
        z = linear(lin, h)
        masks.append((z > 0.0).to(x.dtype))
        h = torch.relu(z)
    y = linear(last, h)
    jac = last.weight.expand(x.shape[0], -1, -1)
    for lin, mask in zip(reversed(net.layers[:-1]), reversed(masks)):
        if mm_dtype is None:
            jac = torch.matmul(jac * mask[:, None, :], lin.weight)
        else:
            rows = (jac * mask[:, None, :]).reshape(-1, lin.out_features)
            jac = _mm(rows, lin.weight, mm_dtype).reshape(
                x.shape[0], -1, lin.in_features)
    if not is_nerf:
        return y, jac
    # chain through the encoding: d[x, sin x, cos x]/dx = [I; diag(cos); -diag(sin)]
    n = x.shape[-1]
    jac = (jac[..., :n] + jac[..., n:2 * n] * torch.cos(x)[:, None, :]
           - jac[..., 2 * n:] * torch.sin(x)[:, None, :])
    return y, jac


def _load_npz(kind: str, n_layers: int):
    data = np.load(os.path.join(_ASSET_NN_DIR, f"{kind}.npz"))
    return ([data[f"weight_{i}"] for i in range(n_layers)],
            [data[f"bias_{i}"] for i in range(n_layers)])


def load_self_collision_nn(dtype=torch.float64, device="cuda") -> CollisionMLP:
    """7-DOF self-collision min-distance model (output in cm)."""
    ws, bs = _load_npz("self", len(SELF_HIDDEN) + 1)
    if ws[0].shape != (SELF_HIDDEN[0], 3 * PANDA_DOF):
        raise ValueError(f"self-collision weights: shape {ws[0].shape}")
    return CollisionMLP(ws, bs, dtype, device)


def load_env_collision_nn(dtype=torch.float64, device="cuda") -> CollisionMLP:
    """Per-link env-collision distance model: input [q(7), obs_pos(3)]."""
    ws, bs = _load_npz("env", len(ENV_HIDDEN) + 1)
    if (ws[0].shape != (ENV_HIDDEN[0], 3 * (PANDA_DOF + 3))
            or ws[-1].shape[0] != PANDA_NUM_LINKS):
        raise ValueError(f"env-collision weights: shapes {ws[0].shape}, "
                         f"{ws[-1].shape}")
    return CollisionMLP(ws, bs, dtype, device)
