"""The tick's per-phase times, the reference's ``ComputeTime``
(`mpcc_manipulator_tpu/solver/sqp_debug.py`).

:func:`mpc_step_profiled` runs the very tick :func:`..mpc.mpc_step` runs
(both QP routes, every configuration) with a :class:`PhaseTimer` around its
phases:

* ``set_env``: the projection, the warm start and RobotData;
* ``set_qp``: the QP assembly (and, on the ADMM path, BFGS and the Hessian
  guard), summed over the SQP iterations;
* ``solve_qp``: the QP solves (with the second-order correction's);
* ``get_alpha``: the line search;
* ``total``: the whole tick.

:func:`solve_ocp_timed` (the dense ADMM route) and
:func:`solve_ocp_timed_riccati` (the Riccati family) are JAX's names for
the SQP loop alone with these phases: ``solve_ocp(timer=...)`` of one
Panda problem, batch-first, returning JAX's ``(z, status, times,
sqp_iters)``.

On the card each phase is a pair of CUDA events on the current stream, read
after one synchronization at the end of the tick, so the timing adds no
host wait inside the tick; on the CPU it is ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..mpc import mpc_step
from ..params import SQPConfig
from ..system import PANDA, System
from .sqp import solve_ocp

@dataclasses.dataclass
class ComputeTime:
    """Per-phase seconds of one tick, summed over its SQP iterations."""

    set_qp: float = 0.0
    solve_qp: float = 0.0
    get_alpha: float = 0.0
    set_env: float = 0.0
    total: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PhaseTimer:
    """Collects the phases of one tick on ``device``: CUDA event pairs on a
    CUDA device, host clock intervals otherwise."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self._spans = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._spans.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((name, t0, time.perf_counter()))

    def times(self) -> ComputeTime:
        """The phases' seconds (on the card, after synchronizing)."""
        if self._cuda:
            torch.cuda.synchronize()
            secs = lambda a, b: a.elapsed_time(b) * 1e-3
        else:
            secs = lambda a, b: b - a
        out = ComputeTime()
        for name, a, b in self._spans:
            setattr(out, name, getattr(out, name) + secs(a, b))
        return out


def mpc_step_profiled(track, params, sel_nn, env_nn, carry, x0, u0, obs_pos,
                      obs_radius, ts: float = 0.01,
                      cfg: SQPConfig = SQPConfig(),
                      exact_heading_jac: bool = False,
                      system: System = PANDA):
    """:func:`..mpc.mpc_step` with its phases timed: ``(new_carry,
    MPCOutput, ComputeTime)``; the carry and output are the untimed
    tick's."""
    timer = PhaseTimer(x0.device)
    with timer.phase("total"):
        carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x0, u0,
                              obs_pos, obs_radius, ts=ts, cfg=cfg,
                              exact_heading_jac=exact_heading_jac,
                              system=system, timer=timer)
    return carry, out, timer.times()


def _solve_ocp_timed(track, rb, params, cfg: SQPConfig, z0, current_u, ts,
                     exact_heading_jac: bool):
    timer = PhaseTimer(z0.device)
    with timer.phase("total"):
        res = solve_ocp(track, rb, params, cfg, z0, current_u, ts,
                        exact_heading_jac=exact_heading_jac, system=PANDA,
                        timer=timer)
    return res.z, res.status, timer.times(), res.sqp_iters


def solve_ocp_timed(track, rb, params, cfg: SQPConfig, z0: torch.Tensor,
                    current_u: torch.Tensor, ts: float,
                    exact_heading_jac: bool = False):
    """The SQP loop on the dense ADMM route with its phases timed (JAX
    `sqp_debug.solve_ocp_timed`, which runs the ADMM solve whatever
    ``cfg.qp_solver`` says): ``(z (B, n_var), status (B,), ComputeTime,
    sqp_iters (B,))`` for the Panda from ``z0`` (B, n_var), cold QP warm
    starts; ``set_env`` stays 0."""
    cfg = dataclasses.replace(cfg, qp_solver="admm", qp_assembly="xla")
    return _solve_ocp_timed(track, rb, params, cfg, z0, current_u, ts,
                            exact_heading_jac)


def solve_ocp_timed_riccati(track, rb, params, cfg: SQPConfig,
                            z0: torch.Tensor, current_u: torch.Tensor,
                            ts: float, exact_heading_jac: bool = False):
    """The SQP loop on the Riccati route ``cfg.qp_solver`` names
    (``"riccati_pallas"``, ``"riccati_struct"`` or ``"riccati"``) with its
    phases timed (JAX `sqp_debug.solve_ocp_timed_riccati`): ``(z, status,
    ComputeTime, sqp_iters)`` as :func:`solve_ocp_timed`, a cold interior
    point on the first iteration."""
    if not cfg.qp_solver.startswith("riccati"):
        raise ValueError(f"qp_solver={cfg.qp_solver!r}: "
                         "solve_ocp_timed_riccati runs the Riccati family")
    return _solve_ocp_timed(track, rb, params, cfg, z0, current_u, ts,
                            exact_heading_jac)
