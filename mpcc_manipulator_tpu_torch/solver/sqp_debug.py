"""The tick's tracer and its per-phase times, the reference's
``ComputeTime`` (`mpcc_manipulator_tpu/solver/sqp_debug.py`).

:class:`PhaseTimer` is the tick's one tracer.  `mpc.mpc_step`,
`solver/sqp.solve_ocp`, `ocp/robot_data.compute_robot_data` and
`solver/qp_admm.solve_qp` take it as ``timer=`` and open a span with
``timer.phase(name)`` around each of their layers (``timer=None`` opens
nothing: every span is a ``contextlib.nullcontext``)::

    tick                  mpc_step, the whole tick
      set_env             steps 1-4 of `mpc.py`
        projection        K6: FK of x0, the projection's Newton loop, vs
        warm_start        the jump test, shift / cold start, unwrap, select
        robot_data        RobotData at the warm start
          robot_data.kin  K4 (or the plain kinematics)
          robot_data.nn   the two collision MLPs and their Jacobians
            robot_data.nn.sel  the self network (K7)
            robot_data.nn.env  the env network (K7; on the mobile system with
                               the obstacle in the moving base frame and
                               the base columns' chain rule)
      set_qp              the QP assembly, each SQP iteration
        assembly          K2 or the plain stage assembly (Riccati)
        build_qp          the dense QP (ADMM)
        hessian_guard     the jittered Cholesky guard (ADMM)
      solve_qp            the QP solves
        ipm               K1 with its warm-start repack, or the plain IPM
        ruiz              Ruiz equilibration (ADMM)
        factor            K^-1, one span a factorization (ADMM)
        admm              the ADMM iterations: one span a K5 launch
                          (phase 1, phase 2), its float32 casts included
      get_alpha           the line search
        eval              K3 or the plain evaluation

Each span records its name, its parent, its tick (the spans under one
outermost span share one id), its host interval (``time.perf_counter_ns``),
on a card a CUDA event pair on the current stream, and the hand-written
kernels it launched (K1-K7, as `ops/cuda_build.launch` counts them in
``cuda_build.LAUNCHES``; the tracer knows no kernel).  A timer built with
``count_ops=True`` also counts the ATen ops each span dispatched to the
device (a ``TorchDispatchMode`` entered for each outermost span; views and
bare allocations, which launch nothing, are left out); counting costs host
time, so keep it off where the host clock is read.  Such a timer also
keeps the tick's per-lane counters (read by :meth:`PhaseTimer.counter`):
``env_rows_active``, each lane's env-collision rows that bind at the
QP's returned step (`solver/sqp.py`, `qp_ipm_kernel.env_rows_active`),
on the Riccati routes, and ``nn_units_active``, each knot's share of a
collision network's hidden units with ``z > 0`` (the units K7 walks),
kept on ``robot_data.nn.sel`` and on ``robot_data.nn.env``.  Under an active
``torch.profiler`` each span is also a ``record_function`` range of its
name, so the program's spans and the device's kernels stand on one
timeline (:meth:`PhaseTimer.idle_gaps`).  Nothing is read inside a tick:
:meth:`PhaseTimer.times` and :meth:`PhaseTimer.spans` read the records
after the ticks, on the card after one synchronize.

:func:`mpc_step_profiled` runs the very tick :func:`..mpc.mpc_step` runs
(both QP routes, every configuration) with a timer and returns its
``ComputeTime``: the phases set_env, set_qp, solve_qp and get_alpha
(summed over the SQP iterations) and ``total``, the whole tick.
:func:`solve_ocp_timed` (the dense ADMM route) and
:func:`solve_ocp_timed_riccati` (the Riccati family) are JAX's names for
the SQP loop alone with these phases: ``solve_ocp(timer=...)`` of one
Panda problem, batch-first, returning JAX's ``(z, status, times,
sqp_iters)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..mpc import mpc_step
from ..ops import cuda_build
from ..params import SQPConfig
from ..system import PANDA, System
from .sqp import solve_ocp

# ATen ops that launch nothing on the device beyond what views do
_NO_LAUNCH = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "_unsafe_view", "lift_fresh"})


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


def _first_device(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device.type
    return None


class _OpCounter(TorchDispatchMode):
    """Counts the ATen ops dispatched on ``device_type`` while entered:
    an op counts where its first tensor argument, or else its first
    output, lives there, unless it is a view or a bare allocation."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace == "aten" and not func.is_view
                and func.overloadpacket.__name__ not in _NO_LAUNCH):
            where = _first_device(args) or _first_device(
                out if isinstance(out, (tuple, list)) else (out,))
            self.n += where == self.device_type
        return out


@dataclasses.dataclass
class _Span:
    name: str
    parent: int              # index of the enclosing span, -1 outermost
    tick: int
    t0: int = 0              # host ns
    t1: int = 0
    events: tuple | None = None
    launches: int = 0        # K1-K7 launches inside
    ops: int | None = None   # ATen ops + launches inside (count_ops)
    kept: dict = dataclasses.field(default_factory=dict)


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class PhaseTimer:
    """Records the spans of ticks on ``device``; ``count_ops=True`` also
    counts each span's ATen ops."""

    def __init__(self, device, count_ops: bool = False):
        dev = torch.device(device)
        self._cuda = dev.type == "cuda"
        self._spans: list[_Span] = []
        self._open: list[int] = []
        self._ticks = 0
        self.count_ops = count_ops
        self._counter = _OpCounter(dev.type) if count_ops else None

    @contextlib.contextmanager
    def phase(self, name: str):
        """A span named ``name`` inside the innermost open one."""
        outer = not self._open
        if outer:
            self._ticks += 1
            if self._counter is not None:
                self._counter.__enter__()
        span = _Span(name, self._open[-1] if self._open else -1,
                     self._ticks - 1)
        self._open.append(len(self._spans))
        self._spans.append(span)
        ranged = torch.autograd.profiler._is_profiler_enabled
        rng = torch.profiler.record_function(name) if ranged else None
        if rng is not None:
            rng.__enter__()
        counter = self._counter
        ops0 = counter.n if counter is not None else 0
        launches0 = sum(cuda_build.LAUNCHES.values())
        if self._cuda:
            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            span.events[0].record()
        span.t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            span.t1 = time.perf_counter_ns()
            if self._cuda:
                span.events[1].record()
            span.launches = sum(cuda_build.LAUNCHES.values()) - launches0
            if counter is not None:
                span.ops = counter.n - ops0 + span.launches
            if rng is not None:
                rng.__exit__(None, None, None)
            self._open.pop()
            if outer and counter is not None:
                counter.__exit__(None, None, None)

    def keep(self, key: str, value: torch.Tensor) -> None:
        """Keep ``value`` (a per-lane tensor, read after the ticks) on the
        innermost open span under ``key``."""
        if not self._open:
            raise ValueError(f"keep({key!r}): no span is open")
        self._spans[self._open[-1]].kept.setdefault(key, []).append(value)

    def counter(self, key: str, span: str | None = None) -> dict | None:
        """The per-lane counter kept under ``key`` (on spans named ``span``
        only, where given), the last value of each tick: ``ticks``,
        ``lane_ticks``, ``per_lane_tick`` (its mean over the lane-ticks)
        and ``share`` (the share of the lane-ticks where it is above 0);
        None where none was kept."""
        last = {}
        for s in self._spans:
            if key in s.kept and span in (None, s.name):
                last[s.tick] = s.kept[key][-1]
        if not last:
            return None
        v = torch.cat([t.reshape(-1) for t in last.values()]).double()
        return dict(ticks=len(last), lane_ticks=v.numel(),
                    per_lane_tick=float(v.mean()),
                    share=float((v > 0).double().mean()))

    def open_spans(self) -> tuple:
        """The names of the open spans, outermost first."""
        return tuple(self._spans[i].name for i in self._open)

    def records(self) -> list:
        """Every span in the order it opened: ``(name, parent index or -1,
        tick, host start ns, host end ns)``."""
        return [(s.name, s.parent, s.tick, s.t0, s.t1) for s in self._spans]

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def times(self) -> ComputeTime:
        """The phases' seconds, ``ComputeTime``'s fields only (on the card
        from the CUDA events, after synchronizing)."""
        self._sync()
        fields = {f.name for f in dataclasses.fields(ComputeTime)}
        out = ComputeTime()
        for s in self._spans:
            if s.name in fields:
                secs = (s.events[0].elapsed_time(s.events[1]) * 1e-3
                        if self._cuda else (s.t1 - s.t0) * 1e-9)
                setattr(out, s.name, getattr(out, s.name) + secs)
        return out

    def _device_ms(self) -> list:
        """Each span's device interval in ms from its tick's first event
        (None off a card)."""
        if not self._cuda:
            return [None] * len(self._spans)
        first = {}
        out = []
        for s in self._spans:
            ref = first.setdefault(s.tick, s.events[0])
            out.append((ref.elapsed_time(s.events[0]),
                        ref.elapsed_time(s.events[1])))
        return out

    def spans(self) -> list:
        """One row a tick and a span name, in the order the spans first
        opened: ``tick``, ``name``, ``parent`` (the enclosing span's
        name), ``count`` (spans of that name in the tick), ``host_ms``,
        ``self_host_ms`` (less the union of its children), ``device_ms``
        and ``self_device_ms`` (CUDA events; None off a card),
        ``launches`` (K1-K7), ``ops`` (ATen ops + launches; None unless
        ``count_ops``), and ``kept``: each kept tensor's mean over its
        lanes, a list a key, one entry a span (K5's iterations for each
        ``admm`` span)."""
        self._sync()
        host = [(s.t0 * 1e-6, s.t1 * 1e-6) for s in self._spans]
        dev = self._device_ms()
        kids: dict = {}
        for i, s in enumerate(self._spans):
            kids.setdefault(s.parent, []).append(i)

        def own(iv, i):
            a, b = iv[i]
            inner = [(max(iv[j][0], a), min(iv[j][1], b))
                     for j in kids.get(i, ())]
            covered = _union([c for c in inner if c[1] > c[0]])
            return (b - a) - sum(hi - lo for lo, hi in covered)

        rows: dict = {}
        for i, s in enumerate(self._spans):
            row = rows.get((s.tick, s.name))
            if row is None:
                row = rows[(s.tick, s.name)] = dict(
                    tick=s.tick, name=s.name,
                    parent=(self._spans[s.parent].name if s.parent >= 0
                            else None),
                    count=0, host_ms=0.0, self_host_ms=0.0,
                    device_ms=0.0 if self._cuda else None,
                    self_device_ms=0.0 if self._cuda else None,
                    launches=0, ops=None, kept={})
            row["count"] += 1
            row["host_ms"] += host[i][1] - host[i][0]
            row["self_host_ms"] += own(host, i)
            if self._cuda:
                row["device_ms"] += dev[i][1] - dev[i][0]
                row["self_device_ms"] += own(dev, i)
            row["launches"] += s.launches
            if s.ops is not None:
                row["ops"] = (row["ops"] or 0) + s.ops
            for key, values in s.kept.items():
                row["kept"].setdefault(key, []).extend(
                    float(v.double().mean()) for v in values)
        return list(rows.values())

    def idle_gaps(self, prof) -> list:
        """From a host-and-device ``torch.profiler`` profile of ticks this
        timer traced: the device's idle gaps inside the outermost spans,
        each put down to the innermost span open at its middle (the spans
        are the profiler's ranges of their names), ``[name, seconds]``
        summed by name, largest first."""
        from torch.autograd import DeviceType
        names = {s.name for s in self._spans}
        outer = {s.name for s in self._spans if s.parent < 0}
        events = prof.events()
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events
                if e.device_type == DeviceType.CPU and e.name in names]
        busy = _union([(e.time_range.start, e.time_range.end)
                       for e in events if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.name not in names])
        gaps: dict = {}
        for w0, w1 in _union([(a, b) for a, b, n in host if n in outer]):
            inside = [(max(a, w0), min(b, w1)) for a, b in busy
                      if min(b, w1) > max(a, w0)]
            edges = [w0] + [x for iv in inside for x in iv] + [w1]
            for a, b in zip(edges[::2], edges[1::2]):
                if b <= a:
                    continue
                mid = 0.5 * (a + b)
                name = min(((e - s, n) for s, e, n in host if s <= mid <= e),
                           default=(0, "outside_spans"))[1]
                gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])]


def per_tick(rows: list) -> dict:
    """Span name -> the mean a tick of each of :meth:`PhaseTimer.spans`'
    numbers (``count``, the ms, ``launches``, ``ops``) over the ticks the
    rows hold, with ``parent``; a span a tick lacks counts 0 there."""
    n = len({r["tick"] for r in rows}) or 1
    out: dict = {}
    for r in rows:
        m = out.setdefault(r["name"], dict(parent=r["parent"]))
        for key in ("count", "host_ms", "self_host_ms", "device_ms",
                    "self_device_ms", "launches", "ops"):
            if r[key] is not None:
                m[key] = m.get(key, 0.0) + r[key] / n
    return out


def format_spans(rows: list) -> str:
    """:func:`per_tick` as a table, one line a span, children indented
    under their parent."""
    means = per_tick(rows)
    depth = {}
    for name, m in means.items():
        depth[name] = depth.get(m["parent"], -1) + 1
    cols = ("count", "host_ms", "self_host_ms", "device_ms",
            "self_device_ms", "launches", "ops")
    lines = ["span (mean a tick)".ljust(24) + "".join(c.rjust(15)
                                                      for c in cols)]
    for name, m in means.items():
        cells = "".join((f"{m[c]:15.4f}" if c in m else "-".rjust(15))
                        for c in cols)
        lines.append(("  " * depth[name] + name).ljust(24) + cells)
    return "\n".join(lines)


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
