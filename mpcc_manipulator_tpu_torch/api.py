"""The reference user surface (`mpcc_manipulator_tpu/api.py`, the reference
package's `python/MPCC/MPCC.py`):

    mpc = MPCC()                      # on the card; MPCC(device="cpu")
    mpc.setTrack(state)
    ok, state, u0, horizon, compute_time = mpc.runMPC(state, input)

plus ``setParam`` (a whitelisted nested dict), ``getSplinePath``,
``getRefPose``, ``getContourError`` and ``getTrackLength``.  Each tick is
one :func:`..mpc.mpc_step` at batch 1 in the JAX package's default
configuration (:func:`..params.reference_sqp_config`: the converged dense
ADMM path, the plain kinematics with the finite-difference manipulability
gradient, float64).  ``sqp_cfg`` is public: set it to ``SQPConfig()`` for
the bench configuration (RTI, K1-K4 on the card).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .models import collision_nn as cnn
from .models import kinematics as kin
from .mpc import init_carry, mpc_step
from .params import DEFAULT_PARAM_DIR, load_params, reference_sqp_config
from .solver.sqp_debug import mpc_step_profiled
from .splines import arc_length as als
from .system import PANDA

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: parameter-key whitelists (the reference's `MPCC.py:37-43`)
PARAM_KEY_WHITELIST = {
    "param": ["max_dist_proj", "desired_ee_velocity", "s_trust_region",
              "tol_sing", "tol_selcol", "tol_envcol", "deaccelerate_ratio"],
    "cost": ["qC", "qCNmult", "qL", "qVs", "qOri", "qSing", "rdq", "rddq",
             "rdVs", "qC_reduction_ratio", "qL_increase_ratio",
             "qOri_reduction_ratio"],
    "bounds": [f"q{i}{s}" for i in range(1, 8) for s in "lu"]
              + ["sl", "su", "vsl", "vsu"]
              + [f"dq{i}{s}" for i in range(1, 8) for s in "lu"]
              + ["dVsl", "dVsu"]
              + [f"ddq{i}{s}" for i in range(1, 8) for s in "lu"],
    "normalization": [f"q{i}" for i in range(1, 8)] + ["s", "vs"]
                     + [f"dq{i}" for i in range(1, 8)] + ["dVs"],
    "sqp": ["eps_prim", "eps_dual", "line_search_tau", "line_search_eta",
            "line_search_rho", "max_iter", "line_search_max_iter", "do_SOC",
            "use_BFGS"],
}


class MPCC:
    """The controller object, with the reference's methods."""

    def __init__(self, param_dir: str | None = None,
                 track_path: str | None = None, dtype=torch.float64,
                 exact_heading_jac: bool = False, device="cuda"):
        with open(os.path.join(param_dir or DEFAULT_PARAM_DIR,
                               "config.json")) as f:
            self.jsonConfig = json.load(f)
        self.Ts = float(self.jsonConfig["Ts"])
        self.pred_horizon = PANDA.horizon
        self.robot_dof = PANDA.dof
        self.num_links = PANDA.num_links
        self.device = torch.device(device)
        self._dtype = dtype
        self._param_dir = param_dir
        self._overrides: dict = {}
        self._exact_heading_jac = exact_heading_jac
        self.setParam({})
        self.sel_nn = cnn.load_self_collision_nn(dtype, self.device)
        self.env_nn = cnn.load_env_collision_nn(dtype, self.device)
        self.track_path = track_path or os.path.join(
            _REPO_ROOT, "assets", "tracks", "track.json")
        self.track = None
        self.track_set = False
        self._carry = None

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               dtype=self._dtype, device=self.device)

    def _state(self, state) -> np.ndarray:
        state = np.asarray(state, dtype=np.float64).reshape(-1)
        if state.size != PANDA.nx:
            raise ValueError(f"State size {state.size} != {PANDA.nx}")
        return state

    def _need_track(self) -> None:
        if not self.track_set:
            raise RuntimeError("Set Track first!")

    # -------------------------------------------------- parameters
    def setParam(self, param_value: dict) -> None:
        """Merge a nested override dict (whitelisted groups and keys) over
        the JSON parameters; ``sqp_cfg`` goes back to the JAX default with
        the sqp.json keys (as in JAX)."""
        for group, values in param_value.items():
            allowed = PARAM_KEY_WHITELIST.get(group)
            if allowed is None:
                raise ValueError(
                    f"Parameter groups must be a subset of "
                    f"{list(PARAM_KEY_WHITELIST)}, got {list(param_value)}")
            if not set(values) <= set(allowed):
                raise ValueError(f"Keys for {group} must be a subset of "
                                 f"{allowed}, got {list(values)}")
            self._overrides.setdefault(group, {}).update(values)
        self.params, loaded = load_params(
            self._param_dir, overrides=self._overrides, dtype=self._dtype,
            device=self.device)
        self.sqp_cfg = reference_sqp_config(loaded)

    # -------------------------------------------------- track
    def setTrack(self, state) -> None:
        """Load the track JSON, shift it to the current EE position (FK on
        the controller's device) and fit the 6-D arc-length spline."""
        state = self._state(state)
        ee = kin.ee_position(self._tensor(state[:PANDA.dof])).cpu().numpy()
        x, y, z, rots = als.load_track_waypoints(self.track_path)
        x, y, z = als.shift_track_to(x, y, z, ee)
        self.track = als.gen_6d_spline(x, y, z, rots, self._dtype,
                                       self.device)
        self.track_set = True
        self._carry = init_carry(1, self._dtype, self.device)

    def getSplinePath(self):
        """``(waypoints (n, 3), rotations (n, 3, 3), s (n,))``."""
        self._need_track()
        s = self.track.s_knots
        return (self.track.wp.cpu().numpy(),
                als.track_orientation(self.track, s).cpu().numpy(),
                s.cpu().numpy())

    def getRefPose(self, path_parameter: float):
        """The track's position (3,) and rotation (3, 3) at s."""
        self._need_track()
        s = self._tensor(path_parameter)
        return (als.track_position(self.track, s).cpu().numpy(),
                als.track_orientation(self.track, s).cpu().numpy())

    def getContourError(self, s: float, ee_posi) -> float:
        self._need_track()
        ref = als.track_position(self.track, self._tensor(s)).cpu().numpy()
        return float(np.linalg.norm(ref - np.asarray(ee_posi)))

    def getTrackLength(self) -> float:
        self._need_track()
        return float(self.track.length)

    # -------------------------------------------------- solve
    def runMPC(self, state, input, obs_position=np.array([3.0, 3.0, 3.0]),
               obs_radius: float = 0.0, profile: bool = False):
        """One control tick: ``(ok, updated_state, u0, horizon,
        compute_time)`` as the reference wrapper returns them.

        ``compute_time`` holds ``total`` (seconds, the tick synchronized at
        its end), the phases ``set_env / set_qp / solve_qp / get_alpha``
        (measured with ``profile=True``, `solver/sqp_debug.py`; else 0.0),
        ``sqp_iters`` and ``qp_iters``."""
        self._need_track()
        x0 = self._tensor(self._state(state))[None]
        u0 = self._tensor(input).reshape(1, PANDA.nu)
        obs = self._tensor(obs_position).reshape(1, 3)
        rad = self._tensor([obs_radius])
        args = (self.track, self.params, self.sel_nn, self.env_nn,
                self._carry, x0, u0, obs, rad)
        kw = dict(ts=self.Ts, cfg=self.sqp_cfg,
                  exact_heading_jac=self._exact_heading_jac)
        if profile:
            self._carry, out, times = mpc_step_profiled(*args, **kw)
            phase = times.as_dict()
            total = phase.pop("total")
        else:
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self._carry, out = mpc_step(*args, **kw)
            if cuda:
                torch.cuda.synchronize(self.device)
            total = time.perf_counter() - t0
            phase = {"set_qp": 0.0, "solve_qp": 0.0, "get_alpha": 0.0,
                     "set_env": 0.0}
        xs = out.horizon_x[0].cpu().numpy()
        us = out.horizon_u[0].cpu().numpy()
        horizon = [{"state": xs[k],
                    "input": us[k] if k < self.pred_horizon
                    else np.zeros(PANDA.nu)}
                   for k in range(self.pred_horizon + 1)]
        compute_time = {"total": total, **phase,
                        "sqp_iters": int(out.sqp_iters[0]),
                        "qp_iters": int(out.qp_iters[0])}
        return (bool(out.ok[0]), out.x0_updated[0].cpu().numpy(),
                out.u0[0].cpu().numpy(), horizon, compute_time)
