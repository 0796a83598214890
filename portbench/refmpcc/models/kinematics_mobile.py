"""Mobile-base (Husky + Panda) kinematics: planar base + 7-DOF arm, batched
over leading dims (`mpcc_manipulator_tpu/models/kinematics_mobile.py`).

Generalized coordinates ``q_m = [x_b, y_b, th_b, q1..q7]`` (NQ_MOBILE =
10): the base is planar prismatic-x / prismatic-y / revolute-z, with the
Panda chain mounted at the base origin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PANDA_DOF
from .kinematics import _det_psd6, fk_chain

NQ_MOBILE = 3 + PANDA_DOF


def _base_transform(base_pose: torch.Tensor):
    """(..., 3) base poses (x_b, y_b, th_b) -> world rotation (..., 3, 3)
    and translation (..., 3) of the base frame."""
    x, y, th = base_pose[..., 0], base_pose[..., 1], base_pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros_like(th), torch.ones_like(th)
    r = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                     torch.stack([z, z, o], -1)], -2)
    return r, torch.stack([x, y, z], -1)


def split_q(q_m: torch.Tensor):
    """(base (..., 3), arm (..., 7))."""
    return q_m[..., :3], q_m[..., 3:]


def ee_position(q_m: torch.Tensor) -> torch.Tensor:
    base, q = split_q(q_m)
    rb, pb = _base_transform(base)
    return pb + (rb @ fk_chain(q)[0][..., None])[..., 0]


def ee_orientation(q_m: torch.Tensor) -> torch.Tensor:
    base, q = split_q(q_m)
    rb, _ = _base_transform(base)
    return rb @ fk_chain(q)[1]


def ee_position_host(q_m) -> np.ndarray:
    """:func:`ee_position` of host data (numpy / a list, (..., 10)) on the
    CPU, as numpy (`kinematics.ee_position_host`)."""
    return ee_position(torch.as_tensor(np.asarray(q_m))).numpy()


def ee_orientation_host(q_m) -> np.ndarray:
    """:func:`ee_orientation` of host data on the CPU, as numpy."""
    return ee_orientation(torch.as_tensor(np.asarray(q_m))).numpy()


def ee_jacobian(q_m: torch.Tensor) -> torch.Tensor:
    """(..., 6, 10) point Jacobian ``[Jv; Jw]`` w.r.t. [x_b, y_b, th_b,
    q1..q7]."""
    base, q = split_q(q_m)
    rb, pb = _base_transform(base)
    p_arm, _, origins, axes = fk_chain(q)
    rbt = rb.transpose(-1, -2)[..., None, :, :]
    p_ee = pb + (rb @ p_arm[..., None])[..., 0]

    # arm columns, rotated into the world through the base
    origins_w = pb[..., None, :] + (origins[..., None, :] @ rbt)[..., 0, :]
    axes_w = (axes[..., None, :] @ rbt)[..., 0, :]
    jv_arm = torch.linalg.cross(axes_w, p_ee[..., None, :] - origins_w)
    # base columns: prismatic x, prismatic y, revolute z about the base origin
    ez = torch.zeros_like(p_ee)
    ez[..., 2] = 1.0
    ex, ey = torch.zeros_like(p_ee), torch.zeros_like(p_ee)
    ex[..., 0] = 1.0
    ey[..., 1] = 1.0
    jv_base = torch.stack([ex, ey, torch.linalg.cross(ez, p_ee - pb)], -2)
    jw_base = torch.stack([torch.zeros_like(ez), torch.zeros_like(ez), ez],
                          -2)
    jv = torch.cat([jv_base, jv_arm], dim=-2).transpose(-1, -2)
    jw = torch.cat([jw_base, axes_w], dim=-2).transpose(-1, -2)
    return torch.cat([jv, jw], dim=-2)


def manipulability(q_m: torch.Tensor) -> torch.Tensor:
    """sqrt(det(J J')) of the full 6x10 Jacobian (RobotData uses the arm's,
    `ocp/robot_data.py`)."""
    j = ee_jacobian(q_m)
    return torch.sqrt(_det_psd6(j @ j.transpose(-1, -2)))
