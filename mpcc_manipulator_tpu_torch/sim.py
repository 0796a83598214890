"""Closed-loop simulation (`mpcc_manipulator_tpu/sim.py`), Panda:

* :func:`closed_loop_scan`: ``n_steps`` ticks of :func:`..mpc.mpc_step` +
  the RK4 plant for a batch of scenarios (B, nx).  A lane whose end-point
  criterion fired (EE within 1 cm and 1e-3 rad of the track's end pose, s
  within 1 cm of the length) freezes: its state, input and carry stay as
  they were.  The freeze is a per-lane selection, so the loop adds no host
  read to what ``mpc_step`` reads itself.
* :class:`ClosedLoopSim`: one scenario, host-driven, logging per tick the
  keys of the JAX package's log (q, qdot, self-collision distance,
  manipulability, s, vs, EE position, solve time, status).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .models import collision_nn as cnn
from .models import dynamics as dyn
from .models import kinematics as kin
from .mpc import MPCCarry, init_carry, mpc_step
from .params import MPCCParams, SQPConfig
from .splines import arc_length as als
from .splines.arc_length import TrackSpline
from .system import PANDA
from .utils import so3

_DOF, _S = PANDA.dof, PANDA.s_idx


def _reached(track: TrackSpline, x: torch.Tensor) -> torch.Tensor:
    """The reference's end-point criterion per lane, x (B, nx)."""
    end_pos = als.track_position(track, track.length)
    end_rot = als.track_orientation(track, track.length)
    p_ee, r_ee, _, _ = kin.fk_chain(x[:, :_DOF])
    ori_err = torch.linalg.vector_norm(
        so3.log_rot_vec(end_rot.transpose(-1, -2) @ r_ee), dim=-1)
    return ((torch.linalg.vector_norm(p_ee - end_pos, dim=-1) < 1e-2)
            & (ori_err < 1e-3) & (torch.abs(x[:, _S] - track.length) < 1e-2))


def closed_loop_scan(track: TrackSpline, params: MPCCParams,
                     sel_nn: cnn.CollisionMLP, env_nn: cnn.CollisionMLP,
                     x_init: torch.Tensor, obs_pos: torch.Tensor,
                     obs_radius: torch.Tensor, n_steps: int = 100,
                     ts: float = 0.01, cfg: SQPConfig = SQPConfig(),
                     exact_heading_jac: bool = False):
    """Rollout of every scenario: x_init (B, nx), obs_pos (B, 3),
    obs_radius (B,).  Returns ``(states (B, T, nx), inputs (B, T, nu),
    status (B, T), ok (B, T), finished (B, T))``, tick t's entries after
    its plant step (a finished lane repeats its frozen state and input)."""
    b, dtype, dev = x_init.shape[0], x_init.dtype, x_init.device
    carry = init_carry(b, dtype, dev)
    x, u = x_init, torch.zeros(b, PANDA.nu, dtype=dtype, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    keep = lambda old, new: torch.where(
        finished.view((-1,) + (1,) * (new.dim() - 1)), old, new)
    traj = []
    for _ in range(n_steps):
        new_carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x, u,
                                  obs_pos, obs_radius, ts=ts, cfg=cfg,
                                  exact_heading_jac=exact_heading_jac)
        x_next = dyn.sim_time_step(out.x0_updated, out.u0, ts)
        fin_next = finished | _reached(track, x_next)
        x, u = keep(x, x_next), keep(u, out.u0)
        carry = MPCCarry(**{
            f.name: keep(getattr(carry, f.name), getattr(new_carry, f.name))
            for f in dataclasses.fields(MPCCarry)})
        finished = fin_next
        traj.append((x, u, out.status, out.ok, finished))
    return tuple(torch.stack(v, dim=1) for v in zip(*traj))


@dataclasses.dataclass
class ClosedLoopSim:
    """Host-driven closed loop of one scenario with per-tick logging; the
    device is the track's."""

    track: TrackSpline
    params: MPCCParams
    sel_nn: cnn.CollisionMLP
    env_nn: cnn.CollisionMLP
    ts: float = 0.01
    cfg: SQPConfig = SQPConfig()
    exact_heading_jac: bool = False
    log: dict = dataclasses.field(default_factory=lambda: {
        "q": [], "qdot": [], "min_dist": [], "mani": [], "s": [], "vs": [],
        "ee_pos": [], "solve_time": [], "status": []})

    def run(self, x0, n_steps: int = 1000, obs_pos=(3.0, 3.0, 3.0),
            obs_radius: float = 0.0, verbose: bool = False):
        """Up to ``n_steps`` ticks from state x0 (nx,), until the end point
        is reached; returns ``(final state (nx,) numpy, log)``."""
        kw = dict(dtype=self.track.length.dtype,
                  device=self.track.length.device)
        cuda = kw["device"].type == "cuda"
        x = torch.tensor(np.asarray(x0, dtype=np.float64), **kw)[None]
        u = torch.zeros(1, PANDA.nu, **kw)
        carry = init_carry(1, kw["dtype"], kw["device"])
        obs = torch.tensor([list(obs_pos)], **kw)
        rad = torch.tensor([obs_radius], **kw)
        for i in range(n_steps):
            if cuda:
                torch.cuda.synchronize(kw["device"])
            t0 = time.perf_counter()
            carry, out = mpc_step(self.track, self.params, self.sel_nn,
                                  self.env_nn, carry, x, u, obs, rad,
                                  ts=self.ts, cfg=self.cfg,
                                  exact_heading_jac=self.exact_heading_jac)
            if cuda:
                torch.cuda.synchronize(kw["device"])
            dt = time.perf_counter() - t0
            u = out.u0
            x = dyn.sim_time_step(out.x0_updated, u, self.ts)

            q = x[:, :_DOF]
            ee = kin.ee_position(q)[0].cpu().numpy()
            mani = float(kin.manipulability(q)[0])
            min_dist = float(self.sel_nn(q)[0, 0])
            s, vs = float(x[0, _S]), float(x[0, PANDA.vs_idx])
            self.log["q"].append(q[0].cpu().numpy())
            self.log["qdot"].append(u[0, :_DOF].cpu().numpy())
            self.log["min_dist"].append(min_dist)
            self.log["mani"].append(mani)
            self.log["s"].append(s)
            self.log["vs"].append(vs)
            self.log["ee_pos"].append(ee)
            self.log["solve_time"].append(dt)
            self.log["status"].append(int(out.status[0]))
            if verbose:
                print(f"step {i:5d}  s={s:.4f} mani={mani:.4f} "
                      f"min_dist={min_dist:.2f}cm t={dt * 1e3:.2f}ms "
                      f"status={int(out.status[0])}")
            if bool(_reached(self.track, x)[0]):
                if verbose:
                    print("End point reached!!!")
                break
        return x[0].cpu().numpy(), self.log
