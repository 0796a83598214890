"""K4: the kinematic half of RobotData as one CUDA kernel launch
(`csrc/kinematics.cu`), replacing the TPU kernel `_kin_kernel` of
`mpcc_manipulator_tpu/ops/pallas_kinematics.py`.

:func:`kin_sweep` computes, for every (scenario, knot) configuration, the
EE position and rotation, the point Jacobians jv / jw, the manipulability
and its analytic gradient.  On CUDA tensors it launches the kernel (or
raises); on CPU tensors it runs the plain version, :func:`kin_sweep_plain`
(`models/kinematics.py` batched).
"""

from __future__ import annotations

import functools

import torch

from ..models import kinematics as kin
from . import cuda_build


def kin_sweep_plain(qs: torch.Tensor):
    """Plain PyTorch version of K4 (any device): qs (..., 7) ->
    ``(p_ee (...,3), r_ee (...,3,3), jv (...,3,7), jw (...,3,7),
    manipul (...), d_manipul (...,7))``."""
    p_ee, r_ee, origins, axes = kin.fk_chain(qs)
    jv = torch.linalg.cross(axes, p_ee[..., None, :] - origins)
    m, dm = kin.manipulability_and_grad_from_frames(p_ee, origins, axes)
    return p_ee, r_ee, jv.transpose(-1, -2), axes.transpose(-1, -2), m, dm


@functools.cache
def _constants(device: str) -> torch.Tensor:
    return torch.tensor(kin.kinematics_constants(), dtype=torch.float32,
                        device=device)


def kin_sweep(qs: torch.Tensor):
    """K4 on CUDA (qs (B, K, 7) float32, contiguous); plain on CPU."""
    if qs.device.type == "cpu":
        return kin_sweep_plain(qs)
    if qs.device.type != "cuda":
        raise ValueError(f"kin_sweep: unsupported device {qs.device}")
    if qs.dtype != torch.float32 or qs.dim() != 3 or qs.shape[-1] != 7 \
            or not qs.is_contiguous():
        raise ValueError("kin_sweep: need a contiguous float32 (B, K, 7) "
                         f"tensor, got {qs.dtype} {tuple(qs.shape)}")
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
        qs.data_ptr(), consts.data_ptr(), b * k, p_ee.data_ptr(),
        r_ee.data_ptr(), jv.data_ptr(), jw.data_ptr(), m.data_ptr(),
        dm.data_ptr(), torch.cuda.current_stream(qs.device).cuda_stream)
    cuda_build.check(err, "K4 kinematics kernel")
    return p_ee, r_ee, jv, jw, m, dm


kin_sweep.launches = 0
