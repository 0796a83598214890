"""A configuration's problem for the reference: the track's waypoints, the
parameters, the collision networks (the port's `problem.py`, driven by a
configuration file instead of fixed constants).

The waypoints are computed once, in float64 on the host, and handed to
both the program and the reference; each side fits its own spline.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import collision_nn as cnn
from .models import kinematics as kin
from .models import kinematics_mobile as kinm
from .params import params_from_groups
from .splines import arc_length as als
from .system import SYSTEMS, System


def system_of(config: dict) -> System:
    return SYSTEMS[config["system"]]


def lissajous(radius: float, amp, n_points: int, freq, phase: float):
    """A Lissajous curve in the EE task plane (`cpp/Params/track.py`)."""
    t = np.linspace(phase, 2 * np.pi + phase, n_points)
    return (amp[0] * radius * np.sin(freq[0] * t),
            amp[1] * radius * np.sin(freq[1] * t),
            amp[2] * radius * np.cos(freq[2] * t))


def waypoints(config: dict):
    """``(x, y, z, rotations)`` of the configuration's track, numpy float64:
    ``"lissajous"`` shifted to start at the home pose's EE position, the
    tool pointing down; ``"line_circle"`` a straight run of ``length`` m
    in x from the home EE position with a ``radius`` m circle in y/z, at
    the home EE orientation."""
    tr, home = config["track"], np.asarray(config["x0_home"], np.float64)
    system = system_of(config)
    q = torch.tensor(home[:system.dof], dtype=torch.float64)
    if tr["kind"] == "lissajous":
        ee = kin.ee_position(q).numpy()
        x, y, z = lissajous(tr["radius"], tr["amp"], tr["n_points"],
                            tr["freq"], tr["phase"])
        x, y, z = als.shift_track_to(x, y, z, ee)
        rots = np.stack([np.diag([1.0, -1.0, -1.0])] * len(x))
        return x, y, z, rots
    if tr["kind"] == "line_circle":
        ee = kinm.ee_position(q).numpy()
        r_ee = kinm.ee_orientation(q).numpy()
        n = tr["n_points"]
        phi = np.linspace(0, 2 * np.pi, n)
        x = np.linspace(0, tr["length"], n) + ee[0]
        y = tr["radius"] * np.cos(phi) - tr["radius"] + ee[1]
        z = tr["radius"] * np.sin(phi) + ee[2]
        return x, y, z, np.tile(r_ee, (n, 1, 1))
    raise ValueError(f"unknown track kind {tr['kind']!r}")


def build(config: dict, dtype, device):
    """``(track, params, sel_nn, env_nn, system)`` of the reference."""
    system = system_of(config)
    x, y, z, rots = waypoints(config)
    track = als.gen_6d_spline(x, y, z, rots, dtype=dtype, device=device)
    params = params_from_groups(config["params"], dtype, system, device)
    return (track, params, cnn.load_self_collision_nn(dtype, device),
            cnn.load_env_collision_nn(dtype, device), system)
