"""Carry weights and state across from the JAX package.

Each function takes one of the JAX package's objects with its leaves given
as numpy arrays (for example ``jax.tree.map(np.asarray, obj)``) and builds
the port's counterpart on a device, reading fields by name.  This module
imports no JAX: the caller does the device-to-host copy.  Floating leaves
are cast to ``dtype``; boolean and integer leaves keep their kind.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from . import mpc, params
from .models.collision_nn import CollisionMLP
from .ocp.qp_stages import StageQPK
from .splines.arc_length import TrackSpline


def _tensor(v, dtype, device):
    a = np.asarray(v)
    if np.issubdtype(a.dtype, np.floating):
        return torch.tensor(a, dtype=dtype, device=device)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    return torch.tensor(a.astype(np.int32), device=device)


def _from_fields(cls, obj, dtype, device):
    """Build dataclass ``cls`` from the same-named attributes of ``obj``,
    recursing into nested dataclass fields."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        sub = hints[f.name]
        kw[f.name] = (_from_fields(sub, v, dtype, device)
                      if dataclasses.is_dataclass(sub)
                      else _tensor(v, dtype, device))
    return cls(**kw)


def mlp(jax_mlp, dtype=torch.float64, device="cuda") -> CollisionMLP:
    """JAX ``MLPParams`` (weights/biases tuples) -> :class:`CollisionMLP`."""
    return CollisionMLP(jax_mlp.weights, jax_mlp.biases, dtype, device)


def mpcc_params(jax_params, dtype=torch.float64,
                device="cuda") -> params.MPCCParams:
    """JAX ``MPCCParams`` -> the port's :class:`~.params.MPCCParams`."""
    return _from_fields(params.MPCCParams, jax_params, dtype, device)


def track(jax_track, dtype=torch.float64, device="cuda") -> TrackSpline:
    """JAX ``TrackSpline`` (coefficient tables) -> :class:`TrackSpline`."""
    return _from_fields(TrackSpline, jax_track, dtype, device)


def carry(jax_carry, dtype=torch.float64, device="cuda") -> mpc.MPCCarry:
    """JAX ``MPCCarry`` (leading batch axis) -> :class:`~.mpc.MPCCarry`,
    every field (the ADMM warm start ``qp_x``/``qp_y`` included)."""
    return _from_fields(mpc.MPCCarry, jax_carry, dtype, device)


def stage_qpk(jax_qpk, dtype=torch.float64, device="cuda") -> StageQPK:
    """Batched JAX ``StageQPK`` (leading batch axis on every field) ->
    :class:`StageQPK`, contiguous."""
    return _from_fields(StageQPK, jax_qpk, dtype, device)
