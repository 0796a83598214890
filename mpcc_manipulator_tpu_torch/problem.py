"""The problems the bench and the tests drive: home pose, track, parameters
and networks (`__graft_entry__._build_problem` of the JAX repo with
``small=False``, and `runtime/track_gen.lissajous_track`, which is numpy
only but imports JAX through its package).

* Panda: the Lissajous track from the home pose's EE position, tool
  pointing down;
* Husky+Panda: 1.2 m of forward travel from the mobile home pose's EE
  position (80 points, a 0.10 m circle in y/z), at the home orientation:
  the track leaves the arm's reach, so the base has to move.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import collision_nn as cnn
from .models import kinematics as kin
from .models import kinematics_mobile as kinm
from .params import load_params
from .splines import arc_length as als
from .system import PANDA, System

# Home state [q(7), s, vs] (reference `main.cpp`)
X0_HOME = np.asarray(
    [0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, np.pi / 4, 0.0, 0.0])
# Mobile: base at the origin, the same arm home pose
X0_HOME_MOBILE = np.asarray(
    [0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, np.pi / 4, 0.0, 0.0])


def lissajous_track(radius: float = 0.1, amp=(2.2, 2.6, 0.0),
                    n_points: int = 100, freq=(1, 2, 1),
                    phase: float = np.pi / 2) -> dict:
    """Lissajous curve in the EE task plane, constant downward orientation
    (reference-format waypoint dict)."""
    t = np.linspace(phase, 2 * np.pi + phase, n_points)
    x = amp[0] * radius * np.sin(freq[0] * t)
    y = amp[1] * radius * np.sin(freq[1] * t)
    z = amp[2] * radius * np.cos(freq[2] * t)
    quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n_points, 1))
    return {
        "X": x.tolist(), "Y": y.tolist(), "Z": z.tolist(),
        "quat_X": quat[:, 0].tolist(), "quat_Y": quat[:, 1].tolist(),
        "quat_Z": quat[:, 2].tolist(), "quat_W": quat[:, 3].tolist(),
    }


def build_problem(dtype=torch.float64, device="cuda",
                  system: System = PANDA):
    """(track, params, sel_nn, env_nn) for ``system``'s problem.

    The track starts at the home pose's EE position (FK in float64 on the
    host)."""
    params, _ = load_params(dtype=dtype, device=device, system=system)
    sel_nn = cnn.load_self_collision_nn(dtype=dtype, device=device)
    env_nn = cnn.load_env_collision_nn(dtype=dtype, device=device)
    if system.base_dof == 0:
        ee = kin.ee_position(torch.tensor(X0_HOME[:7])).numpy()
        tj = lissajous_track()
        x, y, z = als.shift_track_to(np.asarray(tj["X"]), np.asarray(tj["Y"]),
                                     np.asarray(tj["Z"]), ee)
        rots = np.stack([np.diag([1.0, -1.0, -1.0])] * len(x))
    else:
        q_m = torch.tensor(X0_HOME_MOBILE[:system.dof])
        ee = kinm.ee_position(q_m).numpy()
        r_ee = kinm.ee_orientation(q_m).numpy()
        nt = 80
        phi = np.linspace(0, 2 * np.pi, nt)
        x = np.linspace(0, 1.2, nt) + ee[0]
        y = 0.10 * np.cos(phi) - 0.10 + ee[1]
        z = 0.10 * np.sin(phi) + ee[2]
        rots = np.tile(r_ee, (nt, 1, 1))
    track = als.gen_6d_spline(x, y, z, rots, dtype=dtype, device=device)
    return track, params, sel_nn, env_nn
