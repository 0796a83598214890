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
