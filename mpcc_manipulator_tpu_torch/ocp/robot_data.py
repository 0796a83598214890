"""Per-knot kinematic/NN linearization cache ("RobotData")
(`mpcc_manipulator_tpu/ocp/robot_data.py`, fixed-base path).

Computed once per tick at the warm-start guess and frozen for the whole SQP
iteration (reference semantics).  The kinematic half (FK, point Jacobian,
manipulability and its analytic gradient) comes from the K4 sweep
(`ops/kinematics_kernel.py`: the CUDA kernel for CUDA tensors, its plain
version on the CPU); the NN half is batched ``torch`` matmuls.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import collision_nn as cnn
from ..ops.kinematics_kernel import kin_sweep
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


def compute_robot_data(qs: torch.Tensor, obs_pos: torch.Tensor,
                       obs_radius: torch.Tensor, sel_nn: cnn.CollisionMLP,
                       env_nn: cnn.CollisionMLP,
                       system: System = PANDA) -> RobotData:
    """The full cache for joint configurations ``qs`` (B, K, dof), one
    obstacle per scenario (``obs_pos`` (B, 3), ``obs_radius`` (B,))."""
    if system.base_dof != 0:
        raise NotImplementedError("mobile RobotData is ROADMAP item 12")
    b, k, dof = qs.shape
    p_ee, r_ee, jv, jw, mani, d_mani = kin_sweep(qs)
    q_flat = qs.reshape(b * k, dof)
    sel, d_sel = cnn.mlp_forward_jacobian(sel_nn, q_flat)
    env_in = torch.cat([q_flat, obs_pos[:, None, :].expand(b, k, 3)
                        .reshape(b * k, 3)], dim=-1)
    env, d_env_full = cnn.mlp_forward_jacobian(env_nn, env_in)
    n_links = env.shape[-1]
    return RobotData(
        q=qs, ee_pos=p_ee, ee_rot=r_ee, jv=jv, jw=jw,
        manipul=mani, d_manipul=d_mani,
        sel_dist=sel[:, 0].reshape(b, k),
        d_sel_dist=d_sel[:, 0].reshape(b, k, dof),
        env_dist=env.reshape(b, k, n_links),
        # the joint columns only (the reference slices off the obstacle
        # ones), contiguous as K2 and K3 read them
        d_env_dist=d_env_full[:, :, :dof].reshape(b, k, n_links, dof)
        .contiguous(),
        obs_radius=obs_radius.to(qs.dtype)[:, None].expand(b, k),
    )
