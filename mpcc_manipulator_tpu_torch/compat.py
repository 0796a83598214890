"""The reference package's convenience names (`mpcc_manipulator_tpu/
compat.py`, the reference's `python/MPCC/*.py`): ``RobotModel``,
``SelfCollisionNN``, ``EnvCollisionNN``, ``Integrator`` and the free
functions ``getSkewMatrix`` / ``getInverseSkewVector`` / ``LogMatrix`` /
``ExpMatrix`` / ``Log`` / ``Exp`` / ``RotToQuat`` / ``QuatToRot``.

numpy in, numpy out, float64; each computes on a ``device`` that defaults
to the card (pass ``device="cpu"`` without one).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import collision_nn as cnn
from .models import dynamics as dyn
from .models import kinematics as kin
from .models import rigid_body
from .system import PANDA
from .utils import so3


def _arg(v, shape, device) -> torch.Tensor:
    a = np.asarray(v, dtype=np.float64)
    if a.size != int(np.prod(shape)):
        raise ValueError(f"expected {int(np.prod(shape))} values "
                         f"(shape {shape}), got shape {a.shape}")
    return torch.tensor(a.reshape(shape), dtype=torch.float64, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ------------------------------------------------------------------
# SO(3) free functions (the reference's `python/MPCC/utils.py`)
# ------------------------------------------------------------------


def getSkewMatrix(v, device="cuda") -> np.ndarray:
    return _np(so3.hat(_arg(v, (3,), device)))


def getInverseSkewVector(m, device="cuda") -> np.ndarray:
    return _np(so3.vee(_arg(m, (3, 3), device)))


def LogMatrix(r, device="cuda") -> np.ndarray:
    return _np(so3.log_rot(_arg(r, (3, 3), device)))


def ExpMatrix(sk, device="cuda") -> np.ndarray:
    return _np(so3.exp_rot(so3.vee(_arg(sk, (3, 3), device))))


def Log(r, device="cuda") -> np.ndarray:
    return _np(so3.log_rot_vec(_arg(r, (3, 3), device)))


def Exp(v, device="cuda") -> np.ndarray:
    return _np(so3.exp_rot(_arg(v, (3,), device)))


def RotToQuat(r, device="cuda") -> np.ndarray:
    return _np(so3.rot_to_quat(_arg(r, (3, 3), device)))


def QuatToRot(q, device="cuda") -> np.ndarray:
    return _np(so3.quat_to_rot(_arg(q, (4,), device)))


# ------------------------------------------------------------------
# Classes
# ------------------------------------------------------------------


class RobotModel:
    """The reference's `python/MPCC/robot_model.py` surface."""

    def __init__(self, device="cuda"):
        self.num_q = PANDA.dof
        self.device = torch.device(device)

    def _q(self, joint_angle) -> torch.Tensor:
        return _arg(joint_angle, (self.num_q,), self.device)

    def getEEJacobian(self, joint_angle):
        return _np(kin.ee_jacobian(self._q(joint_angle)))

    def getEEJacobianv(self, joint_angle):
        return _np(kin.ee_jacobian(self._q(joint_angle))[:3])

    def getEEJacobianw(self, joint_angle):
        return _np(kin.ee_jacobian(self._q(joint_angle))[3:])

    def getEEPosition(self, joint_angle):
        return _np(kin.ee_position(self._q(joint_angle)))

    def getEEOrientation(self, joint_angle):
        return _np(kin.ee_orientation(self._q(joint_angle)))

    def getEEManipulability(self, joint_angle) -> float:
        return float(kin.manipulability(self._q(joint_angle)))

    def getDManipulability(self, joint_angle):
        return _np(kin.manipulability_gradient_fd(self._q(joint_angle)))

    def getMassMatrix(self, joint_angle):
        return _np(rigid_body.mass_matrix(self._q(joint_angle)))

    def getNonlinearEffect(self, joint_angle, joint_velocity):
        return _np(rigid_body.nonlinear_effects(
            self._q(joint_angle), _arg(joint_velocity, (self.num_q,),
                                       self.device)))


class _CollisionNN:
    def __init__(self, loader, input_size: int, device):
        self._loader = loader
        self._net = None
        self.input_size = input_size
        self.device = torch.device(device)

    def setNeuralNetwork(self, input_size, output_size, hidden_layer_size,
                         is_nerf):
        """Kept for the reference's signature: the weight files fix the
        architecture, so this (re)loads them."""
        if input_size != self.input_size:
            raise ValueError(f"input size {input_size} != "
                             f"{self.input_size}")
        self._net = self._loader(torch.float64, self.device)

    def calculateMlpOutput(self, input, time_verbose: bool = False):
        """``(output (n_out,), d output / d input (n_out, n_in))``."""
        if self._net is None:
            self._net = self._loader(torch.float64, self.device)
        x = _arg(input, (1, self.input_size), self.device)
        y, jac = cnn.mlp_forward_jacobian(self._net, x)
        return _np(y[0]), _np(jac[0])


class SelfCollisionNN(_CollisionNN):
    """The reference's `python/MPCC/self_collision_nn.py` surface: the
    minimum self-collision distance [cm] and its joint Jacobian."""

    def __init__(self, model_path: str = None, device="cuda"):
        super().__init__(cnn.load_self_collision_nn, PANDA.dof, device)


class EnvCollisionNN(_CollisionNN):
    """The reference's `python/MPCC/env_collision_nn.py` surface: per-link
    obstacle distances [cm] for the input [q(7), obstacle position(3)]."""

    def __init__(self, model_path: str = None, device="cuda"):
        super().__init__(cnn.load_env_collision_nn, PANDA.dof + 3, device)


class Integrator:
    """The reference's `python/MPCC/integrator.py` surface (the RK4 plant
    at 1 ms substeps)."""

    def __init__(self, ts: float = 0.01, device="cuda"):
        self.Ts = ts
        self.device = torch.device(device)

    def _xu(self, state, input):
        return (_arg(state, (PANDA.nx,), self.device),
                _arg(input, (PANDA.nu,), self.device))

    def simTimeStep(self, state, input, time_step: float = None):
        return _np(dyn.sim_time_step(*self._xu(state, input),
                                     time_step if time_step else self.Ts))

    def RK4(self, state, input, ts: float):
        return _np(dyn.rk4_step(*self._xu(state, input), ts))

    def EF(self, state, input, ts: float):
        return _np(dyn.euler_step(*self._xu(state, input), ts))
