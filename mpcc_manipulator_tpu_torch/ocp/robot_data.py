"""Per-knot kinematic/NN linearization cache ("RobotData")
(`mpcc_manipulator_tpu/ocp/robot_data.py`).

Computed once per tick at the warm-start guess and frozen for the whole SQP
iteration (reference semantics).  The kinematic half (FK, point Jacobian,
manipulability and its gradient) takes one of two routes, as in JAX
(``kin_backend``):

* ``"pallas"``: the K4 sweep (`ops/kinematics_kernel.py`: the CUDA kernel
  for CUDA tensors, its plain version on the CPU), analytic gradient only;
* ``"xla"``: plain PyTorch on any device, with the gradient ``mani_grad``
  names (``"fd"``, ``"ad"`` or ``"analytic"``; JAX `_single_knot`).  The
  mobile system takes the arm's autodiff gradient whatever ``mani_grad``
  says (JAX `_single_knot_mobile`).

The NN half is batched ``torch`` matmuls on either route.

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

import dataclasses

import torch

from ..models import collision_nn as cnn
from ..models import kinematics as kin
from ..models import kinematics_mobile as kinm
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
             system: System):
    """The NN half over (B, K) knots: ``(sel (B,K), d_sel (B,K,dof), env
    (B,K,L), d_env (B,K,L,dof))``."""
    b, k, dof = qs.shape
    q_flat = qs.reshape(b * k, dof)
    q_arm = q_flat[:, system.arm_slice]
    obs = obs_pos[:, None, :].expand(b, k, 3).reshape(b * k, 3)
    sel, d_sel = cnn.mlp_forward_jacobian(sel_nn, q_arm)
    d_sel = d_sel[:, 0]
    if system.base_dof == 0:
        env, d_env_full = cnn.mlp_forward_jacobian(
            env_nn, torch.cat([q_arm, obs], dim=-1))
        # the joint columns only (the reference slices off the obstacle ones)
        d_env = d_env_full[:, :, :dof]
    else:
        rb, pb = kinm._base_transform(q_flat[:, :3])
        rel = obs - pb
        rbt = rb.transpose(-1, -2)
        obs_local = (rbt @ rel[..., None])[..., 0]
        env, d_env_full = cnn.mlp_forward_jacobian(
            env_nn, torch.cat([q_arm, obs_local], dim=-1))
        arm = system.arm_dof
        d_env_q, d_env_o = d_env_full[:, :, :arm], d_env_full[:, :, arm:]
        # d obs_local / d(x_b, y_b, th_b): -R_b' on the translations, and
        # d(R_b')/dth (obs - p_b) on the yaw
        c, s = torch.cos(q_flat[:, 2]), torch.sin(q_flat[:, 2])
        z = torch.zeros_like(c)
        drt_dth = torch.stack([torch.stack([-s, c, z], -1),
                               torch.stack([-c, -s, z], -1),
                               torch.stack([z, z, z], -1)], -2)
        d_obs_local = torch.cat([-rbt[:, :, :2],
                                 (drt_dth @ rel[..., None])], dim=-1)
        d_env = torch.cat([d_env_o @ d_obs_local, d_env_q], dim=-1)
        d_sel = torch.cat([d_sel.new_zeros(b * k, system.base_dof), d_sel],
                          dim=-1)
    n_links = env.shape[-1]
    return (sel[:, 0].reshape(b, k), d_sel.reshape(b, k, dof),
            env.reshape(b, k, n_links),
            # contiguous, as K2 and K3 read it
            d_env.reshape(b, k, n_links, dof).contiguous())


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
                       env_nn: cnn.CollisionMLP, system: System = PANDA,
                       mani_grad: str = "analytic",
                       kin_backend: str = "pallas") -> RobotData:
    """The full cache for joint configurations ``qs`` (B, K, dof), one
    obstacle per scenario (``obs_pos`` (B, 3), ``obs_radius`` (B,)); the
    kinematic half by the ``kin_backend`` route with the ``mani_grad``
    gradient."""
    if mani_grad not in MANI_GRADS or kin_backend not in KIN_BACKENDS:
        raise ValueError(f"mani_grad {mani_grad!r} / kin_backend "
                         f"{kin_backend!r}: the port runs {MANI_GRADS} / "
                         f"{KIN_BACKENDS}")
    check_kin_route(mani_grad, kin_backend, system)
    b, k, _ = qs.shape
    if kin_backend == "pallas":
        p_ee, r_ee, jv, jw, mani, d_mani = kin_sweep(qs, system)
    else:
        # contiguous, as K2 and K3 read them
        p_ee, r_ee, jv, jw, mani, d_mani = (
            t.contiguous() for t in _kin_half_plain(qs, mani_grad, system))
    sel, d_sel, env, d_env = _nn_half(qs, obs_pos, sel_nn, env_nn, system)
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
