"""Rigid-body dynamics of the Panda: mass matrix and nonlinear effects,
batch-first (`mpcc_manipulator_tpu/models/rigid_body.py`).

The MPC never uses them (the plant is kinematic); they complete the robot
model's surface (`compat.RobotModel.getMassMatrix` / `getNonlinearEffect`).
The mass matrix comes from the composite-rigid-body algorithm in world
coordinates; the nonlinear effects ``C(q, qd) qd + g(q)`` from the mass
matrix's derivative (``torch.func.jacfwd``, the Christoffel terms) and the
gradient of the potential energy (``torch.func.grad``), gravity
(0, 0, -9.81).

The inertial constants are the public Franka Panda link parameters; the
fixed hand, fingers and TCP are merged into link 7.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PANDA_DOF
from ..utils.so3 import hat
from .kinematics import _P_OFF, _R_OFF, _rz

# Link inertial data: mass, COM (link frame), inertia about the COM.
_MASS = np.array([4.97068, 0.646926, 3.2286, 3.5879, 1.22595, 1.66656,
                  0.735522])
_COM = np.array([
    [0.003875, 0.002081, -0.04762],
    [-0.003141, -0.02872, 0.003495],
    [2.7518e-02, 3.9252e-02, -6.6502e-02],
    [-5.317e-02, 1.04419e-01, 2.7454e-02],
    [-1.1953e-02, 4.1065e-02, -3.8437e-02],
    [6.0149e-02, -1.4117e-02, -1.0517e-02],
    [1.0517e-02, -4.252e-03, 6.1597e-02],
])
_INERTIA = np.array([
    [[0.70337, -0.000139, 0.006772], [-0.000139, 0.70661, 0.019169],
     [0.006772, 0.019169, 0.009117]],
    [[0.007962, -0.003925, 0.010254], [-0.003925, 0.02811, 0.000704],
     [0.010254, 0.000704, 0.025995]],
    [[0.037242, -0.004761, -0.011396], [-0.004761, 0.036155, -0.012805],
     [-0.011396, -0.012805, 0.01083]],
    [[0.025853, 0.007796, -0.001332], [0.007796, 0.019552, 0.008641],
     [-0.001332, 0.008641, 0.028323]],
    [[0.035549, -0.002117, -0.004037], [-0.002117, 0.029474, 0.000229],
     [-0.004037, 0.000229, 0.008627]],
    [[0.001964, 0.000109, -0.001158], [0.000109, 0.004354, 0.000341],
     [-0.001158, 0.000341, 0.005433]],
    [[0.012516, -0.000428, -0.001196], [-0.000428, 0.010027, -0.000741],
     [-0.001196, -0.000741, 0.004815]],
])

# hand (0.73 kg) and two fingers (0.015 kg each), rigid on link 7
_C45 = math.sqrt(0.5)
_R_L7_HAND = np.array([[_C45, _C45, 0.0], [-_C45, _C45, 0.0],
                       [0.0, 0.0, 1.0]])
_P_L7_HAND = np.array([0.0, 0.0, 0.107])
_HAND_COM_H = np.array([-0.01, 0.0, 0.03])
_HAND_INERTIA_H = np.diag([0.001, 0.0025, 0.0017])
_FINGER_P = np.array([0.0, 0.0, 0.0584])
_FINGER_I = np.diag([2.375e-06, 2.375e-06, 7.5e-07])

_GRAVITY = np.array([0.0, 0.0, -9.81])


def _merge_hand_into_link7():
    """Link 7's mass, COM and inertia with the hand and fingers folded in
    (parallel-axis theorem)."""
    def to_l7(mass, com_h, inertia_h):
        return (mass, _P_L7_HAND + _R_L7_HAND @ com_h,
                _R_L7_HAND @ inertia_h @ _R_L7_HAND.T)

    bodies = [(_MASS[6], _COM[6], _INERTIA[6]),
              to_l7(0.73, _HAND_COM_H, _HAND_INERTIA_H),
              to_l7(0.015, _FINGER_P, _FINGER_I),
              to_l7(0.015, _FINGER_P, _FINGER_I)]
    m_tot = sum(b[0] for b in bodies)
    com_tot = sum(b[0] * b[1] for b in bodies) / m_tot
    i_tot = np.zeros((3, 3))
    for m, c, i in bodies:
        d = c - com_tot
        i_tot += i + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m_tot, com_tot, i_tot


_M7, _COM7, _I7 = _merge_hand_into_link7()
_MASS_EFF = np.concatenate([_MASS[:6], [_M7]])
_COM_EFF = np.concatenate([_COM[:6], _COM7[None]], axis=0)
_INERTIA_EFF = np.concatenate([_INERTIA[:6], _I7[None]], axis=0)


def _frames(q: torch.Tensor):
    """World rotations (..., 3, 3) and origins (..., 3) of link frames
    1..7 for q (..., 7)."""
    kw = dict(dtype=q.dtype, device=q.device)
    r = torch.eye(3, **kw).expand(q.shape[:-1] + (3, 3))
    p = torch.zeros(q.shape[:-1] + (3,), **kw)
    r_off = torch.tensor(_R_OFF, **kw)
    p_off = torch.tensor(_P_OFF, **kw)
    rs, ps = [], []
    for i in range(PANDA_DOF):
        p = p + r @ p_off[i]
        r = r @ r_off[i] @ _rz(q[..., i])
        rs.append(r)
        ps.append(p)
    return rs, ps


def _com_world(rs, ps, i: int) -> torch.Tensor:
    return ps[i] + rs[i] @ torch.tensor(_COM_EFF[i], dtype=ps[i].dtype,
                                        device=ps[i].device)


def mass_matrix(q: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrix (..., 7, 7) for q (..., 7) by the
    composite-rigid-body algorithm in world coordinates."""
    kw = dict(dtype=q.dtype, device=q.device)
    rs, ps = _frames(q)
    eye = torch.eye(3, **kw).expand(q.shape[:-1] + (3, 3))

    def spatial_inertia(i):
        """Link i's 6x6 spatial inertia about the world origin."""
        m = float(_MASS_EFF[i])
        cx = hat(_com_world(rs, ps, i))
        i_com = rs[i] @ torch.tensor(_INERTIA_EFF[i], **kw) \
            @ rs[i].transpose(-1, -2)
        top = torch.cat([i_com + m * cx @ cx.transpose(-1, -2), m * cx], -1)
        bottom = torch.cat([m * cx.transpose(-1, -2), m * eye], -1)
        return torch.cat([top, bottom], -2)

    # joint i's motion subspace: angular z_i, linear o_i x z_i
    s_cols = []
    for i in range(PANDA_DOF):
        w = rs[i][..., :, 2]
        s_cols.append(torch.cat([w, torch.linalg.cross(ps[i], w)], -1))
    # composite inertias I_c[i] = sum_{j >= i} I_j (a chain)
    comp, acc = [None] * PANDA_DOF, 0.0
    for i in reversed(range(PANDA_DOF)):
        acc = acc + spatial_inertia(i)
        comp[i] = acc
    entry = {}
    for i in range(PANDA_DOF):
        f_i = (comp[i] @ s_cols[i][..., None])[..., 0]
        for j in range(i + 1):
            entry[i, j] = entry[j, i] = (s_cols[j] * f_i).sum(-1)
    return torch.stack([torch.stack([entry[i, j] for j in range(PANDA_DOF)],
                                    -1) for i in range(PANDA_DOF)], -2)


def _potential(q: torch.Tensor) -> torch.Tensor:
    """Gravitational potential energy of the links, q (..., 7)."""
    rs, ps = _frames(q)
    g = torch.tensor(_GRAVITY, dtype=q.dtype, device=q.device)
    return -sum(float(_MASS_EFF[i]) * (g * _com_world(rs, ps, i)).sum(-1)
                for i in range(PANDA_DOF))


def nonlinear_effects(q: torch.Tensor, qdot: torch.Tensor) -> torch.Tensor:
    """``C(q, qd) qd + g(q)`` (..., 7): the joint torques at zero
    acceleration, from the Lagrangian with ``dM/dq`` by forward-mode
    autodiff and ``g = dU/dq`` by reverse mode."""
    flat_q = q.reshape(-1, PANDA_DOF)
    qd = qdot.reshape(-1, PANDA_DOF)
    dm_dq = torch.func.vmap(torch.func.jacfwd(mass_matrix))(flat_q)
    m_dot = torch.einsum("bijk,bk->bij", dm_dq, qd)
    dt_dq = 0.5 * torch.einsum("bjki,bj,bk->bi", dm_dq, qd, qd)
    coriolis = (m_dot @ qd[..., None])[..., 0] - dt_dq
    grav = torch.func.vmap(torch.func.grad(_potential))(flat_q)
    return (coriolis + grav).reshape(q.shape)
