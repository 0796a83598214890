"""System dynamics: exact ZOH discretization and the RK4 plant
(`mpcc_manipulator_tpu/models/dynamics.py`).

``qdot = dq, sdot = vs, vsdot = dVs``.  ``A`` is nilpotent, so the ZOH is
``Ad = I + A Ts``, ``Bd = B Ts + A B Ts^2 / 2`` in closed form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..system import PANDA, System

FINE_TIME_STEP = 1e-3   # plant substep


def continuous_ab(system: System = PANDA) -> tuple[np.ndarray, np.ndarray]:
    """Continuous-time (A, B) as numpy constants."""
    dof, nx, nu = system.dof, system.nx, system.nu
    a = np.zeros((nx, nx))
    a[system.s_idx, system.vs_idx] = 1.0
    b = np.zeros((nx, nu))
    b[:dof, :dof] = np.eye(dof)
    b[system.vs_idx, system.dvs_idx] = 1.0
    return a, b


def discrete_ab(ts: float, system: System = PANDA
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact ZOH (Ad, Bd, gd) via the closed form (A is nilpotent)."""
    a, b = continuous_ab(system)
    ad = np.eye(system.nx) + a * ts
    bd = b * ts + a @ b * (ts * ts / 2.0)
    return ad, bd, np.zeros(system.nx)


def dynamics_f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous dynamics ``f(x, u)`` for x (..., dof+2), u (..., dof+1)."""
    dof = u.shape[-1] - 1
    return torch.cat([u[..., :dof], x[..., dof + 1:dof + 2],
                      u[..., dof:dof + 1]], dim=-1)


def rk4_step(x: torch.Tensor, u: torch.Tensor, ts) -> torch.Tensor:
    """Classic RK4 step."""
    k1 = dynamics_f(x, u)
    k2 = dynamics_f(x + ts / 2.0 * k1, u)
    k3 = dynamics_f(x + ts / 2.0 * k2, u)
    k4 = dynamics_f(x + ts * k3, u)
    return x + ts * (k1 / 6.0 + k2 / 3.0 + k3 / 3.0 + k4 / 6.0)


def sim_time_step(x: torch.Tensor, u: torch.Tensor, ts: float,
                  fine_step: float = FINE_TIME_STEP) -> torch.Tensor:
    """Plant integration: repeated RK4 at 1 ms substeps."""
    for _ in range(int(round(ts / fine_step))):
        x = rk4_step(x, u, fine_step)
    return x
