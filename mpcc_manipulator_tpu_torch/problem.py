"""The problems the bench and the tests drive: home pose, track, parameters
and networks (`__graft_entry__._build_problem` of the JAX repo with
``small=False``; the Panda's track is `runtime/track_gen.lissajous_track`).

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
from .runtime.track_gen import lissajous_track
from .splines import arc_length as als
from .system import PANDA, System

# Home state [q(7), s, vs] (reference `main.cpp`)
X0_HOME = np.asarray(
    [0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, np.pi / 4, 0.0, 0.0])
# Mobile: base at the origin, the same arm home pose
X0_HOME_MOBILE = np.asarray(
    [0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, np.pi / 4, 0.0, 0.0])


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
