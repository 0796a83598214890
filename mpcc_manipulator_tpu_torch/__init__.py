"""PyTorch + CUDA port of the MPCC engine (`mpcc_manipulator_tpu`).

The JAX package beside this one is the reference: every module here has a
counterpart of the same name there and is tested against it.  Tensors are
batch-first (a leading scenario axis replaces ``vmap``); the hot kernels
(kinematics sweep, interior-point QP solve) are hand-written CUDA for Hopper
in ``csrc/``, built with ``nvcc`` at first use.  Importing this package
imports ``torch`` and ``numpy`` only: never JAX, never a compiler.

Top-level exports mirror the JAX package's (the reference Python package's
surface): ``from mpcc_manipulator_tpu_torch import MPCC``.
"""

from .compat import (Exp, ExpMatrix, Integrator, Log, LogMatrix, QuatToRot,
                     RobotModel, RotToQuat, SelfCollisionNN, EnvCollisionNN,
                     getInverseSkewVector, getSkewMatrix)
from .config import N, NPC, NU, NX, PANDA_DOF, PANDA_NUM_LINKS

__all__ = [
    "MPCC", "RobotModel", "SelfCollisionNN", "EnvCollisionNN", "Integrator",
    "getSkewMatrix", "getInverseSkewVector", "LogMatrix", "ExpMatrix",
    "Log", "Exp", "RotToQuat", "QuatToRot",
    "N", "NX", "NU", "NPC", "PANDA_DOF", "PANDA_NUM_LINKS",
]


def __getattr__(name):
    # lazy: api pulls in the whole solver stack
    if name == "MPCC":
        from .api import MPCC
        return MPCC
    raise AttributeError(name)
