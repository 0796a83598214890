"""The tick's tracer (`mpcc_manipulator_tpu_torch/solver/sqp_debug.py`'s
``PhaseTimer``) on the CPU: its spans nest under the tick with their parent
and tick ids; a span's self time is its duration less its children's
union; ``times()`` reads ``ComputeTime``'s fields alone; a traced tick,
counting ops or not, equals the untimed tick bit for bit on the Riccati
and dense ADMM routes; the untimed tick opens no profiler range, and a
traced one opens a range for every span, nested as the spans are; the op
count of a tick is the same for two ticks from one state; the ADMM
iterations of each ``admm`` span are kept per lane; on the Husky+Panda
with the obstacle of the benchmark cell ``husky_panda.fleet-rti-obs-b16384``
a counting timer's ``env_rows_active`` finds binding env-collision rows,
none with the obstacle out of reach, and a plain timer computes none.  A
launch through `ops/cuda_build.launch` of a stand-in C entry (no card:
:func:`fake_card`) counts under its kernel's name and in the span around
it, with no edit to the tracer.  On the card (marker ``card``, skipped
without one): the ``projection`` span is one K6 launch.

Alone: ``python -m pytest tests/test_torch_tracing.py -q``.
"""

import ctypes
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ops import admm_kernel
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
from mpcc_manipulator_tpu_torch.ops import collision_nn_kernel as nnk
from mpcc_manipulator_tpu_torch.ops import cuda_build
from mpcc_manipulator_tpu_torch.ops import kinematics_kernel as kk
from mpcc_manipulator_tpu_torch.ops import projection_kernel as pk
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import (X0_HOME, X0_HOME_MOBILE,
                                                build_problem)
from mpcc_manipulator_tpu_torch.solver import qp_ipm_kernel as qk
from mpcc_manipulator_tpu_torch.solver import sqp_debug
from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import env_rows_active
from mpcc_manipulator_tpu_torch.solver.sqp_debug import (ComputeTime,
                                                         PhaseTimer)
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA

torch.set_num_threads(1)

BATCH = 4
ROUTES = {
    "riccati_pallas": SQPConfig(),
    "admm_pallas": SQPConfig(qp_solver="admm", qp_backend="pallas",
                             qp_assembly="xla"),
    "admm_xla": SQPConfig(qp_solver="admm", qp_backend="xla",
                          qp_assembly="xla", qp_max_iter=50),
}
# every span a tick opens on each route (under RTI: one SQP iteration)
TREE = {
    "riccati_pallas": {
        "tick": None, "set_env": "tick", "projection": "set_env",
        "warm_start": "set_env", "robot_data": "set_env",
        "robot_data.kin": "robot_data", "robot_data.nn": "robot_data",
        "robot_data.nn.sel": "robot_data.nn",
        "robot_data.nn.env": "robot_data.nn",
        "set_qp": "tick", "assembly": "set_qp", "solve_qp": "tick",
        "ipm": "solve_qp", "get_alpha": "tick", "eval": "get_alpha"},
}
TREE["admm_pallas"] = TREE["admm_xla"] = {
    **{k: v for k, v in TREE["riccati_pallas"].items()
       if k in ("tick", "set_env", "projection", "warm_start", "robot_data",
                "robot_data.kin", "robot_data.nn", "robot_data.nn.sel",
                "robot_data.nn.env", "set_qp")},
    "build_qp": "set_qp", "hessian_guard": "set_qp", "solve_qp": "tick",
    "ruiz": "solve_qp", "factor": "solve_qp", "admm": "solve_qp",
    "get_alpha": "tick", "eval": "get_alpha"}


@pytest.fixture(scope="module")
def problem():
    dt = torch.float64
    track, params, sel_nn, env_nn = build_problem(dt, "cpu")
    gen = torch.Generator().manual_seed(11)
    x0 = (torch.tensor(np.tile(X0_HOME, (BATCH, 1)), dtype=dt)
          + 0.01 * torch.randn(BATCH, 9, generator=gen, dtype=dt))
    u0 = torch.zeros(BATCH, 8, dtype=dt)
    obs = torch.tensor([[3.0, 3.0, 3.0]] * BATCH, dtype=dt)
    rad = torch.zeros(BATCH, dtype=dt)
    return (track, params, sel_nn, env_nn), x0, u0, obs, rad


def _tick(problem, cfg, carry=None, timer=None):
    (track, params, sel_nn, env_nn), x0, u0, obs, rad = problem
    carry = carry if carry is not None else init_carry(BATCH, x0.dtype,
                                                       "cpu")
    return mpc_step(track, params, sel_nn, env_nn, carry, x0, u0, obs, rad,
                    cfg=cfg, timer=timer)


def _same(a, b) -> bool:
    """Every tensor field of two dataclasses equal bit for bit."""
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_nest_inside_their_parents(problem, route):
    """Two ticks: each span has its parent and its tick id, and lies inside
    its parent on the host clock; the tree is the route's."""
    timer = PhaseTimer("cpu")
    carry, _ = _tick(problem, ROUTES[route], timer=timer)
    _tick(problem, ROUTES[route], carry=carry, timer=timer)
    recs = timer.records()
    assert {r[2] for r in recs} == {0, 1}
    seen = {}
    for name, parent, tick, t0, t1 in recs:
        assert t0 <= t1
        if parent < 0:
            assert name == "tick"
            continue
        p_name, _, p_tick, p0, p1 = recs[parent]
        assert p_tick == tick and p0 <= t0 and t1 <= p1, (name, p_name)
        seen[name] = p_name
    assert seen == {k: v for k, v in TREE[route].items() if v is not None}
    rows = timer.spans()
    assert [(r["tick"], r["name"]) for r in rows] == [
        (t, n) for t in (0, 1) for n in TREE[route]]
    for r in rows:
        assert r["parent"] == TREE[route][r["name"]]
        assert r["device_ms"] is None and r["ops"] is None
        assert 0.0 <= r["self_host_ms"] <= r["host_ms"]


@pytest.mark.parametrize("children,own", [
    ([], 100.0),
    ([(10, 30), (40, 70)], 50.0),
    ([(10, 30), (30, 60), (90, 100)], 40.0),
    ([(0, 100)], 0.0),
])
def test_self_time_is_the_duration_less_the_childrens_union(
        monkeypatch, children, own):
    """On a scripted host clock: a root span [0, 100] ns with sibling
    children at the given times has self time 100 less their union, and
    each child's self time is its duration (it has no children)."""
    stamps = [0]
    for a, b in children:
        stamps += [a, b]
    stamps.append(100)
    clock = iter(stamps)
    monkeypatch.setattr(sqp_debug.time, "perf_counter_ns",
                        lambda: next(clock))
    timer = PhaseTimer("cpu")
    with timer.phase("root"):
        for k in range(len(children)):
            with timer.phase(f"child{k}"):
                pass
    rows = {r["name"]: r for r in timer.spans()}
    assert rows["root"]["host_ms"] == pytest.approx(100e-6)
    assert rows["root"]["self_host_ms"] == pytest.approx(own * 1e-6)
    for k, (a, b) in enumerate(children):
        assert rows[f"child{k}"]["self_host_ms"] == pytest.approx(
            (b - a) * 1e-6)


def test_union_merges_overlaps():
    """Overlapping and touching intervals merge (the device clock's
    children may overlap where streams do)."""
    assert sqp_debug._union([]) == []
    assert sqp_debug._union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert sqp_debug._union([(5, 6), (0, 10), (10, 12)]) == [[0, 12]]


@pytest.mark.parametrize("route", ["riccati_pallas", "admm_pallas"])
def test_times_reads_compute_time_as_before(problem, route):
    """``times()`` sums ``ComputeTime``'s own fields: the sub-spans stay
    out of it, ``as_dict`` keeps its keys, each phase is the sum of its
    spans, and ``mpc_step_profiled`` returns the untimed tick with every
    phase positive and within the total."""
    timer = PhaseTimer("cpu")
    _tick(problem, ROUTES[route], timer=timer)
    ct = timer.times()
    assert isinstance(ct, ComputeTime)
    assert list(ct.as_dict()) == ["set_qp", "solve_qp", "get_alpha",
                                  "set_env", "total"]
    sums = {}
    for name, _, _, t0, t1 in timer.records():
        sums[name] = sums.get(name, 0.0) + (t1 - t0) * 1e-9
    for key in ("set_qp", "solve_qp", "get_alpha", "set_env"):
        assert getattr(ct, key) == pytest.approx(sums[key])
    assert ct.total == 0.0     # no span named "total" ran

    (track, params, sel_nn, env_nn), x0, u0, obs, rad = problem
    carry = init_carry(BATCH, x0.dtype, "cpu")
    c_ref, o_ref = _tick(problem, ROUTES[route])
    c_p, o_p, ct_p = sqp_debug.mpc_step_profiled(
        track, params, sel_nn, env_nn, carry, x0, u0, obs, rad,
        cfg=ROUTES[route])
    assert _same(c_ref, c_p) and _same(o_ref, o_p)
    d = ct_p.as_dict()
    assert all(d[k] > 0.0 for k in d), d
    assert (d["set_env"] + d["set_qp"] + d["solve_qp"] + d["get_alpha"]
            <= d["total"])


@pytest.mark.parametrize("count_ops", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_traced_tick_equals_the_untimed_tick(problem, route, count_ops):
    """Two ticks traced (ops counted or not) against two untimed ticks
    from the same state: carry and output bit for bit."""
    cfg = ROUTES[route]
    timer = PhaseTimer("cpu", count_ops=count_ops)
    c_ref, o_ref = _tick(problem, cfg)
    c_t, o_t = _tick(problem, cfg, timer=timer)
    assert _same(c_ref, c_t) and _same(o_ref, o_t)
    c_ref, o_ref = _tick(problem, cfg, carry=c_ref)
    c_t, o_t = _tick(problem, cfg, carry=c_t, timer=timer)
    assert _same(c_ref, c_t) and _same(o_ref, o_t)
    ops = [r["ops"] for r in timer.spans() if r["name"] == "tick"]
    assert all(n is not None and n > 0 for n in ops) if count_ops else \
        ops == [None, None]


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


def test_untimed_tick_opens_no_range(problem):
    """``timer=None``: a CPU profile of a tick holds no span's name."""
    names = set(TREE["riccati_pallas"]) | set(TREE["admm_pallas"])
    for cfg in (ROUTES["riccati_pallas"], ROUTES["admm_pallas"]):
        prof = _profiled(lambda: _tick(problem, cfg))
        assert not {e.name for e in prof.events()} & names


@pytest.mark.parametrize("route", ["riccati_pallas", "admm_pallas"])
def test_spans_are_profiler_ranges(problem, route):
    """Under a CPU profiler every recorded span is a range of its name,
    as many of each name as spans, each child's range inside a range of
    its parent's name; without a profiler no range is opened."""
    timer = PhaseTimer("cpu")
    prof = _profiled(lambda: _tick(problem, ROUTES[route], timer=timer))
    recs = timer.records()
    names = {r[0] for r in recs}
    ranges = {}
    for e in prof.events():
        if e.name in names:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    for name in names:
        assert len(ranges[name]) == sum(r[0] == name for r in recs), name
    for name, parent, *_ in recs:
        if parent < 0:
            continue
        p_name = recs[parent][0]
        for a, b in ranges[name]:
            assert any(pa <= a and b <= pb for pa, pb in ranges[p_name]), \
                (name, p_name)
    # the timer's gap reading: no device here, so each tick is one gap,
    # put down to a span open at its middle
    gaps = timer.idle_gaps(prof)
    assert gaps and {g[0] for g in gaps} <= names
    tick_s = sum(b - a for a, b in ranges["tick"]) * 1e-6
    assert sum(g[1] for g in gaps) == pytest.approx(tick_s)


@pytest.mark.parametrize("route", ["riccati_pallas", "admm_pallas"])
def test_op_count_is_the_same_for_two_ticks_from_one_state(problem, route):
    """Counting on: two ticks from the same state count the same ops in
    every span, and a parent counts at least its children."""
    timer = PhaseTimer("cpu", count_ops=True)
    _tick(problem, ROUTES[route], timer=timer)
    _tick(problem, ROUTES[route], timer=timer)
    rows = timer.spans()
    by_tick = [{r["name"]: r["ops"] for r in rows if r["tick"] == t}
               for t in (0, 1)]
    assert by_tick[0] == by_tick[1]
    ops = by_tick[0]
    for name, parent in TREE[route].items():
        kids = [k for k, p in TREE[route].items() if p == name]
        assert ops[name] >= sum(ops[k] for k in kids), name
    assert ops["tick"] > ops["set_env"] > ops["projection"] > 0
    # on the CPU every kernel takes its plain route: nothing launches
    assert all(r["launches"] == 0 for r in rows)
    table = sqp_debug.format_spans(rows)
    assert all(name in table for name in TREE[route])
    means = sqp_debug.per_tick(rows)
    assert means["tick"]["ops"] == ops["tick"]


@pytest.mark.parametrize("route", ["admm_pallas", "admm_xla"])
def test_admm_spans_keep_their_iterations(problem, route):
    """Each ``admm`` span keeps its iterations per lane, read after the
    tick: the two runs of a solve (phase 1, phase 2) sum to the tick's
    ``qp_iters``, phase 1 at most ``check_every``."""
    cfg = ROUTES[route]
    timer = PhaseTimer("cpu")
    _, out = _tick(problem, cfg, timer=timer)
    (row,) = [r for r in timer.spans() if r["name"] == "admm"]
    assert row["count"] == 2
    first, second = row["kept"]["iters"]
    assert first <= cfg.qp_check_every
    assert first + second == pytest.approx(float(out.qp_iters.double()
                                                 .mean()))


def test_keep_needs_an_open_span():
    timer = PhaseTimer("cpu")
    with pytest.raises(ValueError):
        timer.keep("iters", torch.zeros(2))
    with timer.phase("tick"):
        with timer.phase("admm"):
            assert timer.open_spans() == ("tick", "admm")
            timer.keep("iters", torch.tensor([1.0, 3.0]))
    assert timer.open_spans() == ()
    (row,) = [r for r in timer.spans() if r["name"] == "admm"]
    assert row["kept"] == {"iters": [2.0]}


# the obstacle of the benchmark cell husky_panda.fleet-rti-obs-b16384
OBS_TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench", "traffic",
    "fleet-rti-obs-b16384.json")


@pytest.fixture(scope="module")
def mobile():
    """The Husky+Panda at batch 4 from home + 0.01 N(0, 1), float64."""
    dt = torch.float64
    nets = build_problem(dt, "cpu", system=HUSKY_PANDA)
    gen = torch.Generator().manual_seed(11)
    x0 = (torch.tensor(np.tile(X0_HOME_MOBILE, (BATCH, 1)), dtype=dt)
          + 0.01 * torch.randn(BATCH, HUSKY_PANDA.nx, generator=gen,
                               dtype=dt))
    return nets, x0, torch.zeros(BATCH, HUSKY_PANDA.nu, dtype=dt)


def _mobile_tick(mobile, timer, in_reach: bool):
    """One RTI tick (`SQPConfig()`) of the Husky+Panda from a cold carry,
    with the cell's obstacle or with (3, 3, 3) at radius 0."""
    (track, params, sel_nn, env_nn), x0, u0 = mobile
    with open(OBS_TRAFFIC) as f:
        obs = json.load(f)["obstacle"]
    pos, radius = ((obs["position"], obs["radius"]) if in_reach
                   else ([3.0, 3.0, 3.0], 0.0))
    carry = init_carry(BATCH, x0.dtype, "cpu", HUSKY_PANDA)
    return mpc_step(track, params, sel_nn, env_nn, carry, x0, u0,
                    torch.tensor([pos] * BATCH, dtype=x0.dtype),
                    torch.full((BATCH,), radius, dtype=x0.dtype),
                    system=HUSKY_PANDA, timer=timer)


def test_env_rows_active_binds_with_the_cells_obstacle(mobile):
    """Counting on, the cell's obstacle: ``env_rows_active`` counts
    binding env rows, kept once on the tick's solve_qp span; the NN half
    opens ``robot_data.nn.sel`` and ``robot_data.nn.env`` inside
    ``robot_data.nn``."""
    timer = PhaseTimer("cpu", count_ops=True)
    _mobile_tick(mobile, timer, in_reach=True)
    got = timer.counter("env_rows_active")
    assert got["ticks"] == 1 and got["lane_ticks"] == BATCH
    assert got["per_lane_tick"] > 0 and got["share"] > 0, got
    recs = timer.records()
    parents = {name: recs[parent][0] for name, parent, *_ in recs
               if parent >= 0}
    assert parents["robot_data.nn.sel"] == "robot_data.nn"
    assert parents["robot_data.nn.env"] == "robot_data.nn"
    (row,) = [r for r in timer.spans() if r["name"] == "solve_qp"]
    assert list(row["kept"]) == ["env_rows_active"]


def test_env_rows_active_is_zero_out_of_reach(mobile):
    timer = PhaseTimer("cpu", count_ops=True)
    _mobile_tick(mobile, timer, in_reach=False)
    got = timer.counter("env_rows_active")
    assert got["lane_ticks"] == BATCH
    assert got["per_lane_tick"] == 0.0 and got["share"] == 0.0


def test_plain_timer_computes_no_counter(mobile):
    """A timer that does not count ops keeps no counter, and ``times()``
    keeps ``ComputeTime``'s five keys."""
    timer = PhaseTimer("cpu")
    _mobile_tick(mobile, timer, in_reach=True)
    assert timer.counter("env_rows_active") is None
    assert all(not r["kept"] for r in timer.spans())
    assert list(timer.times().as_dict()) == ["set_qp", "solve_qp",
                                             "get_alpha", "set_env", "total"]


def test_env_rows_active_reads_the_env_rows_alone():
    """Crafted packed rows: a row counts where its dual exceeds its slack,
    on a knot's last ``num_links`` rows of knots 0..N-1 only."""
    sy = HUSKY_PANDA
    s = torch.ones(2, sy.horizon + 1, sy.nc_stage)
    lam = torch.ones_like(s)
    lam[0, 0, -1] = 2.0          # the hand row of knot 0
    lam[0, 3, -sy.num_links] = 2.0   # link 0 of knot 3
    s[1, 5, -2] = 1e-3           # a near-zero slack, its dual above it
    lam[1, sy.horizon, -1] = 2.0     # row N holds no stage row
    lam[1, 2, -sy.num_links - 1] = 2.0   # the singularity row
    assert env_rows_active(s, lam, sy).tolist() == [2, 1]


class FakeLibrary:
    """Stands in for the kernel library: each C entry records its name and
    arguments, writes ``replies[entry]`` into the head of a trailing
    ``c_int`` array (a launch config's), and returns ``err``.  A call to an entry of
    `cuda_build._ENTRIES` must bring as many arguments as it declares."""

    def __init__(self):
        self.calls, self.replies, self.err = [], {}, 0

    def __getattr__(self, entry):
        def call(*args):
            if entry == "mpcc_error_string":
                return b"a stand-in error"
            declared = cuda_build._ENTRIES.get(entry)
            assert declared is None or len(args) == len(declared[0]), entry
            self.calls.append((entry, args))
            if args and isinstance(args[-1], ctypes.Array):
                for i, v in zip(range(len(args[-1])),
                                self.replies.get(entry, ())):
                    args[-1][i] = v
            return self.err
        return call


def fake_card(monkeypatch) -> FakeLibrary:
    """Let a wrapper's kernel route run on the CPU: a :class:`FakeLibrary`
    in the library's place, every device's current stream 0, any device
    taken as CUDA (tensors on ``meta`` stand for the card's) and a launch
    counter at 0, all undone after the test."""
    lib = FakeLibrary()
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(cuda_build, "LAUNCHES",
                        dict.fromkeys(cuda_build.LAUNCHES, 0))
    return lib


def test_a_launch_counts_under_its_name_and_in_its_span(monkeypatch):
    """A stand-in kernel "K8" launched through ``cuda_build.launch``: its
    entry gets the arguments and the device's stream, the launch counts
    once under "K8" and in the spans around it (the tracer knows no
    kernel); a failed launch raises, naming the kernel and its detail."""
    lib = fake_card(monkeypatch)
    cpu = torch.device("cpu")
    timer = PhaseTimer(cpu)
    with timer.phase("tick"):
        with timer.phase("k8"):
            cuda_build.launch("K8", "mpcc_k8", 3, 0.5, device=cpu)
        with timer.phase("idle"):
            pass
    assert lib.calls == [("mpcc_k8", (3, 0.5, 0))]
    assert cuda_build.LAUNCHES["K8"] == 1
    assert sum(cuda_build.LAUNCHES.values()) == 1
    launches = {r["name"]: r["launches"] for r in timer.spans()}
    assert launches == {"tick": 1, "k8": 1, "idle": 0}
    lib.err = 700
    with pytest.raises(RuntimeError,
                       match="K8 probe: CUDA error 700 at launch"):
        cuda_build.launch("K8", "mpcc_k8", device=cpu, detail="probe")
    assert cuda_build.LAUNCHES["K8"] == 2


def test_launch_config_and_system_id(monkeypatch):
    """``cuda_build.launch_config`` reads a C entry's report by field name,
    raising on its error; ``system_id`` refuses dims without an
    instantiation before a device that is not CUDA; the wrappers' seven
    readers of a launch config ask their C entries through it, with the
    system's and the dtype's codes.  No reader counts a launch."""
    assert cuda_build.system_id(HUSKY_PANDA, "K1") == 3
    odd = dataclasses.replace(HUSKY_PANDA, base_dof=2)
    with pytest.raises(NotImplementedError, match="K1: no kernel inst"):
        cuda_build.system_id(odd, "K1", torch.device("meta"))
    with pytest.raises(ValueError, match="K1: unsupported device meta"):
        cuda_build.system_id(HUSKY_PANDA, "K1", torch.device("meta"))
    lib = fake_card(monkeypatch)
    lib.replies["mpcc_x_config"] = (7, 9)
    assert cuda_build.launch_config("mpcc_x_config", ("a", "b"), 4) == dict(
        a=7, b=9)
    sel_nn = cnn.load_self_collision_nn(torch.float32, "cpu")
    readers = [(qk.launch_config, (10, HUSKY_PANDA)),
               (ak.launch_config, (3, HUSKY_PANDA, 10, 5, 64)),
               (kk.launch_config, (HUSKY_PANDA, 64)),
               (admm_kernel.launch_config, (179, 479)),
               (pk.launch_config, (HUSKY_PANDA, torch.float64, 64, 100)),
               (nnk.layout, (sel_nn, torch.float64)),
               (nnk.launch_config, (sel_nn, torch.float32, 64))]
    for fn, args in readers:
        assert all(v >= 0 for v in fn(*args).values())
    assert [(e, a[:-1]) for e, a in lib.calls[1:]] == [
        ("mpcc_ipm_launch_config", (3, 10)),
        ("mpcc_assembly_launch_config", (3, 3, 10, 5, 64)),
        ("mpcc_kin_launch_config", (3, 64)),
        ("mpcc_admm_launch_config", (179, 479, 0)),
        ("mpcc_proj_launch_config", (3, 1, 64, 100)),
        ("mpcc_nn_layout", (0, 1)), ("mpcc_nn_launch_config", (0, 0, 64))]
    lib.err = 2
    with pytest.raises(RuntimeError, match=r"mpcc_x_config\(4,\): CUDA"):
        cuda_build.launch_config("mpcc_x_config", ("a",), 4)
    assert sum(cuda_build.LAUNCHES.values()) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("route", ["riccati_pallas", "admm_pallas"])
def test_projection_span_is_one_k6_launch(card, route):
    """On the card, float32, two ticks after a warm-up one: the
    ``projection`` span holds one K6 launch and, counted, at most 5 ops (the
    launch; its outputs' allocations count none)."""
    dt = torch.float32
    track, params, sel_nn, env_nn = build_problem(dt, card)
    gen = torch.Generator().manual_seed(11)
    x0 = (torch.tensor(np.tile(X0_HOME, (BATCH, 1)), dtype=dt)
          + 0.01 * torch.randn(BATCH, 9, generator=gen, dtype=dt)).to(card)
    u0 = torch.zeros(BATCH, 8, dtype=dt, device=card)
    obs = torch.full((BATCH, 3), 3.0, dtype=dt, device=card)
    rad = torch.zeros(BATCH, dtype=dt, device=card)
    carry = init_carry(BATCH, dt, card)
    timer = PhaseTimer(card, count_ops=True)
    for t in range(3):
        carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x0, u0,
                              obs, rad, cfg=ROUTES[route],
                              timer=timer if t else None)
        x0, u0 = out.x0_updated, out.u0
    rows = [r for r in timer.spans() if r["name"] == "projection"]
    assert len(rows) == 2
    for r in rows:
        assert r["launches"] == 1 and r["ops"] <= 5, r
