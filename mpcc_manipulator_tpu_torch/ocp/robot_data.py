"""Per-knot kinematic/NN linearization cache ("RobotData")
(`mpcc_manipulator_tpu/ocp/robot_data.py`).

Computed once per tick at the warm-start guess and frozen for the whole SQP
iteration (reference semantics).  The kinematic half (FK, point Jacobian,
manipulability and its gradient) takes one of two routes, as in JAX
(``kin_backend``):

* ``"pallas"``: the K4 sweep (`ops/kinematics_kernel.py`: the CUDA kernel
  for CUDA tensors, its plain version on the CPU, or as ``kin_interpret``
  names it), analytic gradient only;
* ``"xla"``: plain PyTorch on any device, with the gradient ``mani_grad``
  names (``"fd"``, ``"ad"`` or ``"analytic"``; JAX `_single_knot`).  The
  mobile system takes the arm's autodiff gradient whatever ``mani_grad``
  says (JAX `_single_knot_mobile`).

The NN half, both collision networks' outputs and input Jacobians, is K7
(`ops/collision_nn_kernel.py`) on the route ``kin_interpret`` names: the
CUDA kernel for CUDA tensors, its plain version (batched ``torch``
matmuls, `models/collision_nn.py`) on the CPU; under
``nn_mm_dtype="bfloat16"`` the plain version's products in bf16 with a
float32 product (JAX `_mm`) on either device.

For the mobile system (JAX `_nn_knot`, ``base_dof != 0``):

* self-collision depends on the arm joints only: the base columns of its
  gradient are zero;
* the env-collision MLP was trained with the obstacle in the arm base
  frame, so the world obstacle goes into the moving base frame,
  ``R_b' (obs - p_b)``, and the distance Jacobian's base columns follow by
  the chain rule through that transform;
* the manipulability is the arm's, with a zero base gradient (K4).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from ..models import collision_nn as cnn
from ..models import kinematics as kin
from ..models import kinematics_mobile as kinm
from ..ops import collision_nn_kernel as nnk
from ..ops.kinematics_kernel import kin_sweep, kin_sweep_plain
from ..system import PANDA, System


@dataclasses.dataclass
class RobotData:
    """Batched over (scenario, knot) leading axes (B, K)."""

    q: torch.Tensor            # (B, K, dof)
    ee_pos: torch.Tensor       # (B, K, 3)
    ee_rot: torch.Tensor       # (B, K, 3, 3)
    jv: torch.Tensor           # (B, K, 3, dof)
    jw: torch.Tensor           # (B, K, 3, dof)
    manipul: torch.Tensor      # (B, K)
    d_manipul: torch.Tensor    # (B, K, dof)
    sel_dist: torch.Tensor     # (B, K) [cm]
    d_sel_dist: torch.Tensor   # (B, K, dof)
    env_dist: torch.Tensor     # (B, K, num_links) [cm]
    d_env_dist: torch.Tensor   # (B, K, num_links, dof)
    obs_radius: torch.Tensor   # (B, K) (the scenario's radius on every knot)


def _nn_half(qs: torch.Tensor, obs_pos: torch.Tensor, sel_nn, env_nn,
             system: System, nn_mm_dtype=None,
             phase=contextlib.nullcontext, interpret=None, keep=None):
    """The NN half over (B, K) knots: ``(sel (B,K), d_sel (B,K,dof), env
    (B,K,L), d_env (B,K,L,dof))``, each network by K7 on the route
    ``interpret`` names (`ops/collision_nn_kernel.forward_jacobian`; its
    plain version is `models/collision_nn.py`'s, which also runs the
    ``nn_mm_dtype="bfloat16"`` products).  ``phase`` opens the spans
    ``robot_data.nn.sel`` (the self network) and ``robot_data.nn.env``
    (the env network, with the base-frame transform and the base columns'
    chain rule on the mobile system); ``keep`` (a `PhaseTimer.keep`) takes
    each network's share of its hidden units with ``z > 0`` a knot, as
    ``nn_units_active``."""
    b, k, dof = qs.shape
    base, arm = system.base_dof, system.arm_dof
    q_flat = qs.reshape(b * k, dof)
    run = functools.partial(nnk.forward_jacobian, mm_dtype=nn_mm_dtype,
                            interpret=interpret, count=keep is not None)

    def kept(net, counts):
        if keep is not None:
            keep("nn_units_active", counts / nnk.dense_units(net))

    with phase("robot_data.nn.sel"):
        # the base columns of the self distance's gradient are zero
        sel, d_sel, counts = run(sel_nn, q_flat, base, cols=arm,
                                 offset=base)
        kept(sel_nn, counts)
        sel, d_sel = sel[:, 0].reshape(b, k), d_sel.reshape(b, k, dof)
    with phase("robot_data.nn.env"):
        if base == 0:
            # the joint columns only (the reference slices off the obstacle
            # ones)
            env, d_env, counts = run(env_nn, q_flat, 0, obs_pos, k, cols=dof)
        else:
            obs = obs_pos[:, None, :].expand(b, k, 3).reshape(b * k, 3)
            rb, pb = kinm._base_transform(q_flat[:, :3])
            rel = obs - pb
            rbt = rb.transpose(-1, -2)
            obs_local = (rbt @ rel[..., None])[..., 0]
            env, d_env_full, counts = run(env_nn, q_flat, base, obs_local,
                                          cols=arm + 3)
            d_env_q, d_env_o = d_env_full[:, :, :arm], d_env_full[:, :, arm:]
            # d obs_local / d(x_b, y_b, th_b): -R_b' on the translations,
            # and d(R_b')/dth (obs - p_b) on the yaw
            c, s = torch.cos(q_flat[:, 2]), torch.sin(q_flat[:, 2])
            z = torch.zeros_like(c)
            drt_dth = torch.stack([torch.stack([-s, c, z], -1),
                                   torch.stack([-c, -s, z], -1),
                                   torch.stack([z, z, z], -1)], -2)
            d_obs_local = torch.cat([-rbt[:, :, :2],
                                     (drt_dth @ rel[..., None])], dim=-1)
            d_env = torch.cat([d_env_o @ d_obs_local, d_env_q], dim=-1)
        kept(env_nn, counts)
        n_links = env.shape[-1]
        env = env.reshape(b, k, n_links)
        # contiguous, as K2 and K3 read it
        d_env = d_env.reshape(b, k, n_links, dof).contiguous()
    return sel, d_sel, env, d_env


MANI_GRADS = ("fd", "ad", "analytic")
KIN_BACKENDS = ("pallas", "xla")


def check_kin_route(mani_grad: str, kin_backend: str,
                    system: System = PANDA) -> None:
    """The JAX package's ``ValueError`` where it raises one: K4 computes
    the analytic gradient only, so the fixed base's fd and ad gradients
    take the plain route."""
    if kin_backend == "pallas" and system.base_dof == 0 \
            and mani_grad != "analytic":
        raise ValueError(
            "kin_backend='pallas' implements the analytic manipulability"
            " gradient only; set mani_grad='analytic' (or kin_backend="
            "'xla' for the fd/ad variants)")


def _kin_half_plain(qs: torch.Tensor, mani_grad: str, system: System):
    """The plain kinematic half over configurations qs (..., dof): ``(p_ee,
    r_ee, jv, jw, manipul, d_manipul)``, K4's outputs (with the analytic
    gradient on the fixed base, K4's plain version)."""
    if system.base_dof != 0:
        q_arm = qs[..., system.arm_slice]
        j = kinm.ee_jacobian(qs)
        d_arm = kin.manipulability_gradient_ad(q_arm)
        return (kinm.ee_position(qs), kinm.ee_orientation(qs), j[..., :3, :],
                j[..., 3:, :], kin.manipulability(q_arm),
                torch.cat([d_arm.new_zeros(d_arm.shape[:-1]
                                           + (system.base_dof,)), d_arm],
                          dim=-1))
    if mani_grad == "analytic":
        return kin_sweep_plain(qs, system)
    p_ee, r_ee, origins, axes = kin.fk_chain(qs)
    jv = torch.linalg.cross(axes, p_ee[..., None, :] - origins)
    d_mani = (kin.manipulability_gradient_fd(qs) if mani_grad == "fd"
              else kin.manipulability_gradient_ad(qs))
    return (p_ee, r_ee, jv.transpose(-1, -2), axes.transpose(-1, -2),
            kin.manipulability(qs), d_mani)


def compute_robot_data(qs: torch.Tensor, obs_pos: torch.Tensor,
                       obs_radius: torch.Tensor, sel_nn: cnn.CollisionMLP,
                       env_nn: cnn.CollisionMLP, mani_grad: str = "fd",
                       system: System = PANDA, kin_backend: str = "xla",
                       kin_interpret: bool | None = None,
                       nn_mm_dtype: str | None = None,
                       timer=None) -> RobotData:
    """The full cache for joint configurations ``qs`` (B, K, dof), one
    obstacle per scenario (``obs_pos`` (B, 3), ``obs_radius`` (B,)); the
    kinematic half by the ``kin_backend`` route with the ``mani_grad``
    gradient, K4 (``"pallas"``) on the route ``kin_interpret`` names
    (`ops/cuda_build.kernel_route`), and the NN half by K7 on that route,
    or by its plain version's products in ``nn_mm_dtype`` (``"bfloat16"``:
    ``SQPConfig.nn_bf16``).  JAX's order and defaults:
    the plain kinematics with the finite-difference gradient; the bench
    route is ``mani_grad="analytic", kin_backend="pallas"``.  ``timer``
    (a `solver.sqp_debug.PhaseTimer`) traces the halves as the spans
    ``robot_data.kin`` and ``robot_data.nn`` (with ``robot_data.nn.sel``
    and ``robot_data.nn.env`` inside); a counting timer also keeps each
    network's ``nn_units_active`` on its span."""
    if mani_grad not in MANI_GRADS or kin_backend not in KIN_BACKENDS:
        raise ValueError(f"mani_grad {mani_grad!r} / kin_backend "
                         f"{kin_backend!r}: the port runs {MANI_GRADS} / "
                         f"{KIN_BACKENDS}")
    check_kin_route(mani_grad, kin_backend, system)
    phase = timer.phase if timer is not None else contextlib.nullcontext
    b, k, _ = qs.shape
    with phase("robot_data.kin"):
        if kin_backend == "pallas":
            p_ee, r_ee, jv, jw, mani, d_mani = kin_sweep(qs, system,
                                                         kin_interpret)
        else:
            # contiguous, as K2 and K3 read them
            p_ee, r_ee, jv, jw, mani, d_mani = (
                t.contiguous()
                for t in _kin_half_plain(qs, mani_grad, system))
    keep = timer.keep if timer is not None and timer.count_ops else None
    with phase("robot_data.nn"):
        sel, d_sel, env, d_env = _nn_half(qs, obs_pos, sel_nn, env_nn,
                                          system, nn_mm_dtype, phase,
                                          kin_interpret, keep)
    return RobotData(
        q=qs, ee_pos=p_ee, ee_rot=r_ee, jv=jv, jw=jw,
        manipul=mani, d_manipul=d_mani, sel_dist=sel, d_sel_dist=d_sel,
        env_dist=env, d_env_dist=d_env,
        obs_radius=obs_radius.to(qs.dtype)[:, None].expand(b, k),
    )


def index_robot_data(rb: RobotData, k) -> RobotData:
    """Select knot ``k`` of every scenario: each field (B, K, ...) ->
    (B, ...)."""
    return RobotData(**{f.name: getattr(rb, f.name)[:, k]
                        for f in dataclasses.fields(RobotData)})
