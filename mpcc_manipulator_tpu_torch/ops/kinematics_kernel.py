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
`models/kinematics_mobile.py` batched).  ``interpret=True`` runs the plain
version on either device and ``interpret=False`` the kernel only, as JAX's
``interpret`` switch does (`cuda_build.kernel_route`).
"""

from __future__ import annotations

import functools
import math

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
def _constants(device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The FK's constant tables on ``device`` (K4 reads float32, K6 the
    state's dtype)."""
    return torch.tensor(kin.kinematics_constants(), dtype=dtype,
                        device=device)


# The kernel's launch, as `csrc/kinematics.cu` fixes it: one thread a
# configuration, K4_THREADS threads a block, the block's static shared
# memory (floats) the constants and its share of the six outputs.
K4_THREADS = 64
NCONST = 96
_LAUNCH = ("threads", "configs_per_block", "blocks", "shared_bytes",
           "blocks_per_sm", "registers", "local_bytes", "sms")


def out_widths(dof: int) -> tuple:
    """Floats a configuration of each output: p, R, jv, jw, m, dm."""
    return (3, 9, 3 * dof, 3 * dof, 1, dof)


def launch_geometry(system: System, n: int) -> dict:
    """K4's launch at ``n`` configurations, as the C entry computes it:
    threads a block, configurations a block (one a thread), blocks, static
    shared bytes a block."""
    floats = NCONST + K4_THREADS * sum(out_widths(system.dof))
    return dict(threads=K4_THREADS, configs_per_block=K4_THREADS,
                blocks=-(-n // K4_THREADS), shared_bytes=4 * floats)


def launch_config(system: System, n: int) -> dict:
    """:func:`launch_geometry` as the card reports it
    (`mpcc_kin_launch_config`), with the blocks an SM holds at once, the
    kernel's registers and local-memory (stack and spill) bytes a thread,
    and the card's SM count."""
    return cuda_build.launch_config("mpcc_kin_launch_config", _LAUNCH,
                                    cuda_build.system_id(system, "K4"), n)


@functools.lru_cache(maxsize=64)
def _layout(b: int, k: int, dof: int) -> tuple:
    """(total floats, ((shape, stride, offset) of each output)): the six
    outputs back to back in one buffer, each starting on a 16-byte
    boundary (the kernel's 16-byte stores)."""
    views, off = [], 0
    for shape, width in zip(((b, k, 3), (b, k, 3, 3), (b, k, 3, dof),
                             (b, k, 3, dof), (b, k), (b, k, dof)),
                            out_widths(dof)):
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        views.append((shape, stride, off))
        off += -(-b * k * width // 4) * 4
    return off, tuple(views)


def alloc_outputs(b: int, k: int, dof: int, device) -> tuple:
    """K4's six outputs for (b, k) configurations: contiguous, disjoint
    float32 views of one ``torch.empty`` (p, R, jv, jw, m, dm)."""
    total, views = _layout(b, k, dof)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    return tuple(buf.as_strided(shape, stride, off)
                 for shape, stride, off in views)


def kin_sweep(qs: torch.Tensor, system: System = PANDA,
              interpret: bool | None = None):
    """K4 on CUDA (qs (B, K, dof) float32, contiguous); plain on CPU.
    ``interpret`` names the route (`cuda_build.kernel_route`): ``True``
    runs the plain version on either device, ``False`` the kernel only."""
    if cuda_build.kernel_route(interpret, qs.device, "kin_sweep") == "plain":
        return kin_sweep_plain(qs, system)
    sid = cuda_build.system_id(system, "K4", qs.device)
    cuda_build.check_tensor(f"kin_sweep: {system.name}'s (B, K, dof) qs", qs,
                            (*qs.shape[:2], system.dof), qs.device)
    b, k, dof = qs.shape
    outs = alloc_outputs(b, k, dof, qs.device)
    base = outs[0].data_ptr()
    cuda_build.launch(
        "K4", "mpcc_kin_sweep", qs.data_ptr(),
        _constants(qs.device).data_ptr(), b * k, sid,
        *(base + 4 * off for _, _, off in _layout(b, k, dof)[1]),
        device=qs.device, detail="kinematics kernel")
    return outs
