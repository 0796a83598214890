"""K6: the tick's projection (`mpc.py` step 1) as one CUDA kernel launch
(`csrc/kinematics.cu`, ``proj_kernel``).

:func:`project_and_vs` takes the fleet's states ``x0`` (B, nx) and inputs
``u0`` (B, nu) and returns ``(x0_updated, s_proj)``: the EE's arc-length
projection onto the track near the state's s (the waypoint fallback past
``max_dist_proj``, up to 20 Newton steps, `splines/arc_length.py::
project_on_spline`), and x0 with that s and the re-derived
``vs = (Jv dq) . t(s_proj)``.  On CUDA tensors it launches the kernel's
instantiation for the system, in float32 or float64 (or raises); on CPU
tensors it runs the plain version, :func:`project_and_vs_plain`, the eager
chain the kernel replaces.  ``interpret=True`` runs the plain version on
either device and ``interpret=False`` the kernel only
(`cuda_build.kernel_route`).

No TPU kernel stands behind it: the JAX package leaves step 1 to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import kinematics as kin
from ..models import kinematics_mobile as kinm
from ..splines import arc_length as als
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from . import cuda_build
from .kinematics_kernel import NCONST, _constants

SHARED_LIMIT = 48 * 1024   # the kernel's dynamic shared memory, bytes
_LAUNCH = ("threads", "blocks", "shared_bytes", "blocks_per_sm",
           "registers", "local_bytes", "sms")


def project_and_vs_plain(track: TrackSpline, x0: torch.Tensor,
                         u0: torch.Tensor, max_dist_proj,
                         system: System = PANDA):
    """Plain PyTorch version of K6 (any device): ``(x0_updated (B, nx),
    s_proj (B,))``."""
    dof = system.dof
    q = x0[:, :dof]
    dq = u0[:, :dof]
    last_s = x0[:, system.s_idx]
    if system.base_dof == 0:
        p_ee, _, origins, axes = kin.fk_chain(q)
        jv = torch.linalg.cross(axes, p_ee[:, None, :] - origins)
    else:
        p_ee = kinm.ee_position(q)
        jv = kinm.ee_jacobian(q)[:, :3].transpose(-1, -2)  # B,10,3
    s_proj = als.project_on_spline(track, last_s, p_ee, max_dist_proj)
    vs = ((dq[:, :, None] * jv).sum(1)
          * als.track_derivative(track, s_proj)).sum(-1)
    x0_new = x0.clone()
    x0_new[:, system.s_idx] = s_proj
    x0_new[:, system.vs_idx] = vs
    return x0_new, s_proj


def tables(track: TrackSpline, max_dist_proj) -> tuple:
    """The track's tensors in the order the C entry reads them: a, b, c, d
    of the x, y and z channels, the waypoints, the knots, each channel's
    delta and length, the track's length and ``max_dist_proj``."""
    chans = (track.sx, track.sy, track.sz)
    return (*(t for sp in chans for t in (sp.a, sp.b, sp.c, sp.d)),
            track.wp, track.s_knots,
            *(t for sp in chans for t in (sp.delta, sp.length)),
            track.length, max_dist_proj)


def shared_bytes(nk: int, dtype) -> int:
    """The kernel's dynamic shared memory a block: K4's constants and the
    track's 16 values a knot."""
    return (NCONST + 16 * nk) * (4 if dtype == torch.float32 else 8)


def launch_config(system: System, dtype, n: int, nk: int) -> dict:
    """K6's launch at ``n`` lanes and ``nk`` knots as the card reports it
    (`mpcc_proj_launch_config`): threads and blocks, dynamic shared bytes a
    block, the blocks an SM holds at once, registers and local-memory bytes
    a thread, the card's SM count."""
    return cuda_build.launch_config(
        "mpcc_proj_launch_config", _LAUNCH, cuda_build.system_id(system, "K6"),
        cuda_build.DTYPES[dtype], n, nk)


def _check(x0: torch.Tensor, u0: torch.Tensor, tabs: tuple,
           system: System) -> int:
    """Raise unless the kernel takes these tensors; the knot count."""
    if x0.dtype not in cuda_build.DTYPES:
        raise ValueError(f"project_and_vs: float32 or float64, got "
                         f"{x0.dtype}")
    b = x0.shape[0]
    if x0.dim() != 2 or x0.shape[1] != system.nx \
            or tuple(u0.shape) != (b, system.nu):
        raise ValueError(f"project_and_vs: {system.name} needs x0 (B, "
                         f"{system.nx}) and u0 (B, {system.nu}), got "
                         f"{tuple(x0.shape)} and {tuple(u0.shape)}")
    if u0.dtype != x0.dtype or u0.device != x0.device \
            or any(t.stride(-1) != 1 and t.shape[-1] != 1 for t in (x0, u0)):
        raise ValueError(
            "project_and_vs: x0 and u0 with contiguous rows, in one dtype on "
            f"one device; got u0 {u0.dtype} on {u0.device}, strides "
            f"{x0.stride()} and {u0.stride()}")
    nk = tabs[0].shape[0]
    what = f"project_and_vs: the track ({nk} knots) and max_dist_proj"
    for t, shape in zip(tabs, [(nk,)] * 12 + [(nk, 3), (nk,)] + [()] * 8):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{what} as tensors, got {type(t)}")
        cuda_build.check_tensor(what, t, shape, x0.device, (x0.dtype,))
    if nk < 2 or shared_bytes(nk, x0.dtype) > SHARED_LIMIT:
        raise ValueError(f"project_and_vs: {nk} knots; the kernel takes 2 "
                         f"to what {SHARED_LIMIT} B of shared memory holds")
    return nk


def project_and_vs(track: TrackSpline, x0: torch.Tensor, u0: torch.Tensor,
                   max_dist_proj, system: System = PANDA,
                   interpret: bool | None = None):
    """K6 on CUDA (x0 (B, nx) and u0 (B, nu) with contiguous rows, the
    track and ``max_dist_proj`` (0-d) contiguous, all in float32 or all in
    float64); plain on CPU.  ``interpret`` names the route
    (`cuda_build.kernel_route`): ``True`` runs the plain version on either
    device, ``False`` the kernel only."""
    if cuda_build.kernel_route(interpret, x0.device,
                               "project_and_vs") == "plain":
        return project_and_vs_plain(track, x0, u0, max_dist_proj, system)
    sid = cuda_build.system_id(system, "K6", x0.device)
    tabs = tables(track, max_dist_proj)
    nk = _check(x0, u0, tabs, system)
    b = x0.shape[0]
    x0_new = torch.empty(b, system.nx, dtype=x0.dtype, device=x0.device)
    s_proj = torch.empty(b, dtype=x0.dtype, device=x0.device)
    ptrs = (ctypes.c_void_p * len(tabs))(*(t.data_ptr() for t in tabs))
    cuda_build.launch(
        "K6", "mpcc_project_vs", x0.data_ptr(), x0.stride(0), u0.data_ptr(),
        u0.stride(0), _constants(x0.device, x0.dtype).data_ptr(), ptrs, b,
        nk, sid, cuda_build.DTYPES[x0.dtype], x0_new.data_ptr(),
        s_proj.data_ptr(), device=x0.device, detail="projection kernel")
    return x0_new, s_proj
