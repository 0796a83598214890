"""K4: the kinematic half of RobotData as one CUDA kernel launch
(`csrc/kinematics.cu`), replacing the TPU kernel `_kin_kernel` of
`mpcc_manipulator_tpu/ops/pallas_kinematics.py`, both of its branches.

:func:`kin_sweep` computes, for every (scenario, knot) configuration, the
EE position and rotation, the point Jacobians jv / jw, the manipulability
and its analytic gradient; for the mobile system the arm's quantities are
composed with the planar base (the manipulability is the arm's, with a zero
gradient on the base columns).  On CUDA tensors it launches the kernel's
instantiation for the system (or raises); on CPU tensors it runs the plain
version, :func:`kin_sweep_plain` (`models/kinematics.py` and
`models/kinematics_mobile.py` batched).
"""

from __future__ import annotations

import functools

import torch

from ..models import kinematics as kin
from ..models import kinematics_mobile as kinm
from ..system import PANDA, System
from . import cuda_build


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


@functools.cache
def _constants(device: str) -> torch.Tensor:
    return torch.tensor(kin.kinematics_constants(), dtype=torch.float32,
                        device=device)


def kin_sweep(qs: torch.Tensor, system: System = PANDA):
    """K4 on CUDA (qs (B, K, dof) float32, contiguous); plain on CPU."""
    if qs.device.type == "cpu":
        return kin_sweep_plain(qs, system)
    sid = cuda_build.system_id(system, "K4")
    if qs.device.type != "cuda":
        raise ValueError(f"kin_sweep: unsupported device {qs.device}")
    if qs.dtype != torch.float32 or qs.dim() != 3 \
            or qs.shape[-1] != system.dof or not qs.is_contiguous():
        raise ValueError(f"kin_sweep: {system.name} needs a contiguous "
                         f"float32 (B, K, {system.dof}) tensor, got "
                         f"{qs.dtype} {tuple(qs.shape)}")
    b, k, dof = qs.shape
    kw = dict(dtype=torch.float32, device=qs.device)
    p_ee = torch.empty(b, k, 3, **kw)
    r_ee = torch.empty(b, k, 3, 3, **kw)
    jv = torch.empty(b, k, 3, dof, **kw)
    jw = torch.empty(b, k, 3, dof, **kw)
    m = torch.empty(b, k, **kw)
    dm = torch.empty(b, k, dof, **kw)
    consts = _constants(str(qs.device))
    lib = cuda_build.library()
    kin_sweep.launches += 1
    err = lib.mpcc_kin_sweep(
        qs.data_ptr(), consts.data_ptr(), b * k, sid,
        p_ee.data_ptr(), r_ee.data_ptr(), jv.data_ptr(), jw.data_ptr(),
        m.data_ptr(), dm.data_ptr(),
        torch.cuda.current_stream(qs.device).cuda_stream)
    cuda_build.check(err, "K4 kinematics kernel")
    return p_ee, r_ee, jv, jw, m, dm


kin_sweep.launches = 0
