"""PyTorch + CUDA port of the MPCC engine (`mpcc_manipulator_tpu`).

The JAX package beside this one is the reference: every module here has a
counterpart of the same name there and is tested against it.  Tensors are
batch-first (a leading scenario axis replaces ``vmap``); the hot kernels
(kinematics sweep, interior-point QP solve) are hand-written CUDA for Hopper
in ``csrc/``, built with ``nvcc`` at first use.  Importing this package
imports ``torch`` and ``numpy`` only: never JAX, never a compiler.
"""
