"""Per-tick RobotData cache, plain PyTorch: the kinematic half (the port's
K4 plain version, analytic manipulability gradient) and the collision NNs'
distances and Jacobians over every (scenario, knot) configuration
(`mpcc_manipulator_tpu/ocp/robot_data.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import collision_nn as cnn
from ..models import kinematics_mobile as kinm
from ..models.kin_sweep import kin_sweep_plain
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


def compute_robot_data(qs: torch.Tensor, obs_pos: torch.Tensor,
                       obs_radius: torch.Tensor, sel_nn: cnn.CollisionMLP,
                       env_nn: cnn.CollisionMLP,
                       system: System = PANDA) -> RobotData:
    """The full cache for joint configurations ``qs`` (B, K, dof), one
    obstacle per scenario (``obs_pos`` (B, 3), ``obs_radius`` (B,))."""
    b, k, _ = qs.shape
    p_ee, r_ee, jv, jw, mani, d_mani = kin_sweep_plain(qs, system)
    sel, d_sel, env, d_env = _nn_half(qs, obs_pos, sel_nn, env_nn, system)
    return RobotData(
        q=qs, ee_pos=p_ee, ee_rot=r_ee, jv=jv, jw=jw,
        manipul=mani, d_manipul=d_mani, sel_dist=sel, d_sel_dist=d_sel,
        env_dist=env, d_env_dist=d_env,
        obs_radius=obs_radius.to(qs.dtype)[:, None].expand(b, k),
    )
