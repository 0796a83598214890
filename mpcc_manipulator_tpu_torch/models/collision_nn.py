"""Learned collision-distance models: MLP forward + input Jacobian
(`mpcc_manipulator_tpu/models/collision_nn.py`).

* self-collision: q (7,) -> min link-link distance [cm], 21->256->64->1;
* env-collision: [q (7,), obs_pos (3,)] -> per-link distance [cm] (9),
  30->256x4->9;

both with the "NeRF" input encoding ``[x, sin x, cos x]``.  The Jacobian is
accumulated from the output side (both nets have fewer outputs than encoded
inputs), ``J <- (J * relu'(z_l)) @ W_l`` with ReLU' taken as ``z > 0``; the
batched products are plain ``torch`` matmuls.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..config import PANDA_DOF, PANDA_NUM_LINKS

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
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
        h = nerf_encode(x)
        for lin in self.layers[:-1]:
            h = torch.relu(lin(h))
        return self.layers[-1](h)


def mlp_forward_jacobian(net: CollisionMLP, x: torch.Tensor):
    """Forward pass + analytic input Jacobian.

    ``x`` (B, n_in) -> ``(y (B, n_out), dy/dx (B, n_out, n_in))``.
    """
    h = nerf_encode(x)
    last = net.layers[-1]
    if last.out_features >= h.shape[-1]:
        raise ValueError("output-side Jacobian accumulation needs fewer "
                         "outputs than encoded inputs")
    masks = []
    for lin in net.layers[:-1]:
        z = lin(h)
        masks.append((z > 0.0).to(x.dtype))
        h = torch.relu(z)
    y = last(h)
    jac = last.weight.expand(x.shape[0], -1, -1)
    for lin, mask in zip(reversed(net.layers[:-1]), reversed(masks)):
        jac = torch.matmul(jac * mask[:, None, :], lin.weight)
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
