"""What runs in the window: the program, or the reference in its place.

A side builds its problem from a configuration and offers ``init(batch)``
(the cold carry), ``tick(carry, x, u, obs_pos, obs_radius, timer)`` (one
MPC tick for the whole fleet: ``(carry, out)``) and ``plant(x, u)`` (the
next states).  :class:`Program` is the system under test, the PyTorch and
CUDA port; :class:`Reference` is the plain reference of `refmpcc/`, in
the dtype it is given (the control runs it in float32 with TF32 on).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import torch

from refmpcc import problem as ref_problem

from . import spec


def check_networks(config: dict) -> None:
    """The collision networks' files are the ones the configuration names."""
    for name, net in config["networks"].items():
        with open(os.path.join(spec.ROOT, net["file"]), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != net["sha256"]:
            raise SystemExit(f"{net['file']}: sha256 {digest}, the "
                             f"configuration names {net['sha256']}")


def _sqp_config(cls, traffic: dict):
    return cls(**traffic.get("sqp_config", {}))


class _Side:
    """A tick and a plant over ``self._mpc`` / ``self._dyn`` (the program's
    modules or the reference's, which share their signatures)."""

    def init(self, batch: int):
        return self._mpc.init_carry(batch, self.dtype, self.device,
                                    self.system)

    def tick(self, carry, x, u, obs_pos, obs_radius, timer=None):
        return self._mpc.mpc_step(
            self.track, self.params, self.sel_nn, self.env_nn, carry, x, u,
            obs_pos, obs_radius, ts=self.ts, cfg=self.cfg,
            system=self.system, timer=timer)

    def plant(self, x, u):
        return self._dyn.sim_time_step(x, u, self.ts, self.substep)


class Program(_Side):
    """The port (`mpcc_manipulator_tpu_torch`) on ``device``, in the
    configuration's dtype."""

    def __init__(self, config: dict, traffic: dict, device):
        from mpcc_manipulator_tpu_torch import mpc
        from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
        from mpcc_manipulator_tpu_torch.models import dynamics
        from mpcc_manipulator_tpu_torch.params import SQPConfig, load_params
        from mpcc_manipulator_tpu_torch.splines import arc_length as als
        from mpcc_manipulator_tpu_torch.system import SYSTEMS

        check_networks(config)
        self._mpc, self._dyn = mpc, dynamics
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.system = dataclasses.replace(SYSTEMS[config["system"]],
                                          horizon=config["horizon"])
        self.cfg = _sqp_config(SQPConfig, traffic)
        self.ts, self.substep = config["ts"], config["plant_substep"]
        g = config["params"]
        self.params, _ = load_params(
            overrides={"param": g["model"], "cost": g["cost"],
                       "bounds": g["bounds"],
                       "normalization": g["normalization"], "sqp": g["sqp"]},
            dtype=self.dtype, system=self.system, device=device)
        x, y, z, rots = ref_problem.waypoints(config)
        self.track = als.gen_6d_spline(x, y, z, rots, dtype=self.dtype,
                                       device=device)
        self.sel_nn = cnn.load_self_collision_nn(self.dtype, device)
        self.env_nn = cnn.load_env_collision_nn(self.dtype, device)


class Reference(_Side):
    """The plain reference (`refmpcc/`) in ``dtype`` on ``device``."""

    def __init__(self, config: dict, traffic: dict, device,
                 dtype=torch.float64):
        from refmpcc import mpc
        from refmpcc.models import dynamics
        from refmpcc.params import SQPConfig

        check_networks(config)
        self._mpc, self._dyn = mpc, dynamics
        self.device, self.dtype = torch.device(device), dtype
        self.cfg = _sqp_config(SQPConfig, traffic)
        self.ts, self.substep = config["ts"], config["plant_substep"]
        (self.track, self.params, self.sel_nn, self.env_nn,
         system) = ref_problem.build(config, dtype, device)
        self.system = dataclasses.replace(system, horizon=config["horizon"])
