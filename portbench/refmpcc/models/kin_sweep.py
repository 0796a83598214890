"""The kinematic half of RobotData, plain PyTorch: the port's K4 plain
version (`ops/kinematics_kernel.kin_sweep_plain`).
"""

from __future__ import annotations

import torch

from ..system import PANDA, System
from . import kinematics as kin
from . import kinematics_mobile as kinm


def kin_sweep_plain(qs: torch.Tensor, system: System = PANDA):
    """Plain PyTorch version of K4 (any device): qs (..., dof) ->
    ``(p_ee (...,3), r_ee (...,3,3), jv (...,3,dof), jw (...,3,dof),
    manipul (...), d_manipul (...,dof))``."""
    if qs.shape[-1] != system.dof:
        raise ValueError(f"kin_sweep_plain: {system.name} needs (..., "
                         f"{system.dof}) configurations, got "
                         f"{tuple(qs.shape)}")
    p_ee, r_ee, origins, axes = kin.fk_chain(qs[..., system.arm_slice])
    m, dm = kin.manipulability_and_grad_from_frames(p_ee, origins, axes)
    if system.base_dof == 0:
        jv = torch.linalg.cross(axes, p_ee[..., None, :] - origins)
        return (p_ee, r_ee, jv.transpose(-1, -2), axes.transpose(-1, -2), m,
                dm)
    j = kinm.ee_jacobian(qs)
    dm = torch.cat([dm.new_zeros(dm.shape[:-1] + (system.base_dof,)), dm],
                   dim=-1)
    return (kinm.ee_position(qs), kinm.ee_orientation(qs), j[..., :3, :],
            j[..., 3:, :], m, dm)
