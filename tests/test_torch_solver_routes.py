"""The packed ``riccati`` and the ``riccati_struct`` solver routes, fleet
mode and the timed SQP loops of the port against the JAX package, float64
on the CPU.

* the stage assemblies `build_qp_stages` (packed StageQP),
  `build_qp_stages_s` (StageQPS) and `pack_stage_qp` against JAX's at
  1e-13 relative to each block's scale, both systems, from the same
  iterates and the same RobotData (JAX's, carried over);
* the packed IPM `solve_qp_ipm` against JAX's, both centering schemes,
  cold and warm started (the SQP's clip [0.1, 100]), ``fixed_iters`` both
  ways: equal Newton iterations and verdicts, steps within 1e-8 (JAX's
  `tests/test_qp_ipm.py` bounds); ``fixed_iters`` bit-identical to the
  early exit in the port, for both plain solvers;
* `mpc_step` on both routes with the second-order correction and with the
  merit line search, closed loop tick for tick against JAX's, both
  systems (states within 1e-9; under the filter a lane may leave JAX's
  run only where its filter decided by rounding, the A/B finding);
* fleet mode: the same ticks bit for bit as without it on every Riccati
  route, JAX's fleet tick within 1e-9, and exactly ``max_iter`` SQP
  iterations (and ``ipm_max_iter`` Newton trips on the plain IPMs);
* `sqp_debug.solve_ocp_timed(_riccati)`: positive phases and the result of
  `solve_ocp`, on ADMM and the three Riccati routes;
* `ee_position_host` / `ee_orientation_host` of both systems against
  JAX's; `check_supported` accepting every ``SQPConfig`` value JAX has,
  ``ipm_interpret``'s three among them.

In the converged mode the filter can compare two l1 violations that are
both rounding (ROADMAP section 3): the two packages' summation orders then
round its decision differently.  The comparison stops following such a
lane, at most one, and only with that signature in the port's own
evaluations.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.models import kinematics_mobile as jkinm
from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
from mpcc_manipulator_tpu.solver import qp_ipm as jipm
from mpcc_manipulator_tpu.system import HUSKY_PANDA as JHUSKY
from mpcc_manipulator_tpu.system import PANDA as JPANDA
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kinm
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp import qp_data
from mpcc_manipulator_tpu_torch.ocp import qp_stages as qps
from mpcc_manipulator_tpu_torch.ocp.robot_data import (RobotData,
                                                       compute_robot_data)
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME, X0_HOME_MOBILE
from mpcc_manipulator_tpu_torch.solver import qp_ipm, sqp, sqp_debug
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA

torch.set_num_threads(1)

TS = 0.01
B = 3
DT = torch.float64
SYSTEMS = {"panda": (JPANDA, PANDA, X0_HOME),
           "husky_panda": (JHUSKY, HUSKY_PANDA, X0_HOME_MOBILE)}
ASSEMBLY_TOL = 1e-13    # relative to the block's scale
STEP_TOL = 1e-8         # JAX tests/test_qp_ipm.py
STATE_TOL = 1e-9
TICKS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, what, tol):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


@functools.lru_cache(maxsize=None)
def _problem(name):
    """`__graft_entry__._build_problem`'s float64 problem for one system,
    on both sides (the port's carried over by ``convert``), and B start
    states at home + 0.01 N(0, 1), s and vs non-negative."""
    from __graft_entry__ import _build_problem
    jsys, sys_, x_home = SYSTEMS[name]
    track, params, _, sel_nn, env_nn, _, _, u0, obs = _build_problem(
        jnp.float64, small=False, system=jsys)
    port = dict(track=convert.track(_np(track), device="cpu"),
                params=convert.mpcc_params(_np(params), device="cpu"),
                sel_nn=convert.mlp(_np(sel_nn), device="cpu"),
                env_nn=convert.mlp(_np(env_nn), device="cpu"))
    rng = np.random.default_rng(17)
    x0 = x_home[None] + 0.01 * rng.standard_normal((B, sys_.nx))
    x0[:, sys_.s_idx:] = np.abs(x0[:, sys_.s_idx:])
    jax_side = dict(track=track, params=params, sel_nn=sel_nn, env_nn=env_nn,
                    u0=u0, obs=obs)
    return name, jax_side, port, x0


@functools.lru_cache(maxsize=None)
def _qp_point(name):
    """Iterates z (the cold-start horizon at the start states + 0.002
    N(0,1)), current inputs, and JAX's RobotData at z on both sides."""
    _, j, port, x0 = _problem(name)
    jsys, sys_, _ = SYSTEMS[name]
    rng = np.random.default_rng(3)
    zs = (np.concatenate([np.tile(x0, (1, sys_.horizon + 1)),
                          np.zeros((B, sys_.nu * sys_.horizon))], axis=1)
          + 0.002 * rng.standard_normal((B, sys_.n_var)))
    cu = 0.05 * rng.standard_normal((B, sys_.nu))

    def robot_data(z):
        xs = z[:sys_.nx * (sys_.horizon + 1)].reshape(-1, sys_.nx)
        return j_robot_data(xs[:, :sys_.dof], j["obs"], jnp.asarray(0.0),
                            j["sel_nn"], j["env_nn"], mani_grad="ad",
                            system=jsys)

    jrb = jax.jit(jax.vmap(robot_data))(jnp.asarray(zs))
    fields = {}
    for f in dataclasses.fields(RobotData):
        a = np.asarray(getattr(jrb, f.name))
        if f.name == "obs_radius":
            a = np.repeat(a[:, None], sys_.horizon + 1, axis=1)
        fields[f.name] = torch.tensor(a, dtype=DT)
    return name, j, port, zs, cu, jrb, RobotData(**fields)


@pytest.fixture(scope="module", params=list(SYSTEMS))
def problem(request):
    return _problem(request.param)


@pytest.fixture(scope="module", params=list(SYSTEMS))
def qp_point(request):
    return _qp_point(request.param)


def _jax_stages(qp_point, build):
    name, j, _, zs, cu, jrb, _ = qp_point
    jsys = SYSTEMS[name][0]
    return _np(jax.jit(jax.vmap(lambda z, c, rb: build(
        j["track"], z, rb, j["params"], c, TS, False, system=jsys)))(
            jnp.asarray(zs), jnp.asarray(cu), jrb))


def _port_stages(qp_point, build):
    name, _, port, zs, cu, _, rb = qp_point
    return build(port["track"], torch.tensor(zs, dtype=DT), rb,
                 port["params"], torch.tensor(cu, dtype=DT), TS,
                 system=SYSTEMS[name][1])


def _check_fields(got, ref, tol):
    for f in dataclasses.fields(got):
        a = getattr(ref, f.name)
        g = getattr(got, f.name)
        _close(g, np.broadcast_to(a, g.shape), f.name, tol)


@pytest.mark.parametrize("assembly", ["build_qp_stages",
                                      "build_qp_stages_s", "pack_stage_qp"])
def test_stage_assembly_matches_jax(qp_point, assembly):
    """Every field of the packed and structured stage QPs, and the packing
    of JAX's own StageQPS, within 1e-13 of JAX's (JAX holds its packing to
    the packed assembly at that bound, `tests/test_qp_ipm.py`)."""
    sys_ = SYSTEMS[qp_point[0]][1]
    if assembly == "pack_stage_qp":
        ref = _jax_stages(qp_point, jqs.build_qp_stages)
        qs_j = _jax_stages(qp_point, jqs.build_qp_stages_s)
        got = qps.pack_stage_qp(qps.StageQPS(**{
            f.name: torch.tensor(np.asarray(getattr(qs_j, f.name)), dtype=DT)
            for f in dataclasses.fields(qps.StageQPS)}), sys_)
        assert isinstance(got, qps.StageQP)
    else:
        ref = _jax_stages(qp_point, getattr(jqs, assembly))
        got = _port_stages(qp_point, getattr(qps, assembly))
    _check_fields(got, ref, ASSEMBLY_TOL)
    if assembly != "build_qp_stages_s":
        # the packed rows' activity: state box knots 1..N, the rest 0..N-1
        m = got.mask[0]
        assert float(m[0, :2 * sys_.nx].sum()) == 0.0
        assert float(m[-1, 2 * sys_.nx:].sum()) == 0.0
        assert float(m.sum()) == sys_.horizon * sys_.nc_stage


@pytest.fixture(scope="module")
def packed_qp(qp_point):
    """The packed StageQP at the QP point: JAX's and the port's."""
    return (_jax_stages(qp_point, jqs.build_qp_stages),
            _port_stages(qp_point, qps.build_qp_stages), qp_point[0])


def _warm_rows(sol):
    return (torch.clamp(sol.s_rows, 0.1, 100.0),
            torch.clamp(sol.lam_rows, 0.1, 100.0))


@pytest.mark.parametrize("fixed", [False, True], ids=["early_exit", "fixed"])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("scheme", ["adaptive", "mehrotra"])
def test_packed_ipm_matches_jax(packed_qp, scheme, start, fixed):
    jq, qp, _ = packed_qp
    ws = wl = None
    if start == "warm":
        ws, wl = _warm_rows(qp_ipm.solve_qp_ipm(qp, scheme=scheme))
    sol = qp_ipm.solve_qp_ipm(qp, 25, scheme, fixed, ws, wl)
    kw = {} if ws is None else dict(warm_s=jnp.asarray(ws.numpy()),
                                    warm_lam=jnp.asarray(wl.numpy()))
    ref = jax.vmap(lambda q, a: jipm.solve_qp_ipm(
        q, max_iter=25, scheme=scheme, fixed_iters=fixed, **a))(
            jax.tree.map(jnp.asarray, jq), kw)
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(sol.solved.numpy(), np.asarray(ref.solved))
    assert bool(sol.solved.all())
    for f in ("du", "dx_tilde"):
        err = float(np.abs(getattr(sol, f).numpy()
                           - np.asarray(getattr(ref, f))).max())
        assert err < STEP_TOL, (f, err)
    _close(sol.lam_rows, ref.lam_rows, "lam_rows", 1e-6)
    if fixed:
        other = qp_ipm.solve_qp_ipm(qp, 25, scheme, False, ws, wl)
        for f in dataclasses.fields(sol):
            assert torch.equal(getattr(sol, f.name),
                               getattr(other, f.name)), f.name


@pytest.mark.parametrize("scheme", ["adaptive", "mehrotra"])
def test_struct_ipm_fixed_iters_bit_identical(qp_point, scheme, monkeypatch):
    """``solve_qp_ipm_s(fixed_iters=True)`` runs all ``max_iter`` Newton
    trips (a sweep each) and returns the early exit's result bit for
    bit."""
    qs_ = _port_stages(qp_point, qps.build_qp_stages_s)
    ref = qp_ipm.solve_qp_ipm_s(qs_, 25, scheme=scheme)
    calls = []
    sweep = "_riccati_ff_s" if scheme == "mehrotra" else "_riccati_forward_s"
    original = getattr(qp_ipm, sweep)
    monkeypatch.setattr(qp_ipm, sweep,
                        lambda *a: calls.append(1) or original(*a))
    got = qp_ipm.solve_qp_ipm_s(qs_, 25, scheme=scheme, fixed_iters=True)
    assert len(calls) == 25 * (2 if scheme == "mehrotra" else 1)
    assert int(ref.iters.max()) < 25
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), \
            f.name


VIO_ROUNDOFF = 100 * torch.finfo(DT).eps   # gates.VIO_ROUNDOFF eps


def _rounding_decided(trials) -> np.ndarray:
    """Lanes whose filter compared, at some SQP iteration after the first,
    a trial that raised the objective while both l1 violations lay at
    roundoff: its dominance test was decided by rounding (the A/B finding,
    ROADMAP section 3; `gates.roundoff_steps`).  ``trials``: the (obj,
    vio) of each line-search evaluation of one tick, (B,) each."""
    obj = torch.stack([o for o, _ in trials]).numpy()
    vio = torch.stack([v for _, v in trials]).numpy()
    return ((obj[1:] > obj[:-1]) & (vio[1:] < VIO_ROUNDOFF)
            & (vio[:-1] < VIO_ROUNDOFF)).any(axis=0)


def _loop(problem, cfg, jcfg, ticks):
    """``ticks`` closed-loop ticks of the port's `mpc_step` (the B lanes
    as one batch) and of JAX's (vmapped); per tick ok, status, SQP and IPM
    iterations equal and states within STATE_TOL.  Under the filter a lane
    may leave JAX's run only at a tick where its filter decided by
    rounding (:func:`_rounding_decided`, from the port's evaluations of
    that tick); it is compared no further, and at most one lane may.
    Returns the port's outputs."""
    name, j, port, x0 = problem
    jsys, sys_, _ = SYSTEMS[name]
    zero = jnp.asarray(0.0, jnp.float64)
    step = jax.jit(jax.vmap(lambda c, x, u: jax_mpc_step(
        j["track"], j["params"], j["sel_nn"], j["env_nn"], c, x, u,
        j["obs"], zero, ts=TS, cfg=jcfg, system=jsys)))
    sim = jax.jit(jax.vmap(lambda x, u: jdyn.sim_time_step(x, u, TS)))
    jc = jax.tree.map(lambda a: jnp.stack([a] * B),
                      j_init_carry(jnp.float64, jsys))
    xj, uj = jnp.asarray(x0), jnp.stack([j["u0"]] * B)
    carry = init_carry(B, DT, "cpu", sys_)
    x = torch.tensor(x0, dtype=DT)
    u = torch.zeros(B, sys_.nu, dtype=DT)
    obs = torch.tensor(np.asarray(j["obs"]), dtype=DT).expand(B, 3)
    rad = torch.zeros(B, dtype=DT)
    trials, evaluate = [], ak.eval_point_plain
    decided = np.zeros(B, dtype=bool)
    outs = []
    for t in range(ticks):
        trials.clear()
        ak.eval_point_plain = lambda *a: trials.append(evaluate(*a)) \
            or trials[-1]
        try:
            carry, out = mpc_step(port["track"], port["params"],
                                  port["sel_nn"], port["env_nn"], carry, x,
                                  u, obs, rad, ts=TS, cfg=cfg, system=sys_)
        finally:
            ak.eval_point_plain = evaluate
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        jc, oj = step(jc, xj, uj)
        uj, xj = oj.u0, sim(oj.x0_updated, oj.u0)
        gap = np.abs(x.numpy() - np.asarray(xj)).max(axis=1)
        new = (gap >= STATE_TOL) & ~decided
        if new.any():
            assert cfg.line_search == "filter", (t, gap)
            assert _rounding_decided(trials)[new].all(), (t, gap)
            decided |= new
        keep = ~decided
        for f in ("ok", "status", "sqp_iters", "qp_iters"):
            np.testing.assert_array_equal(
                getattr(out, f).numpy()[keep],
                np.asarray(getattr(oj, f))[keep], err_msg=f"{f}, tick {t}")
        outs.append((carry, out, x))
    assert decided.sum() <= 1, decided
    assert bool(out.ok.all())
    return outs


MODES = {"soc": dict(do_SOC=True), "merit": dict(line_search="merit")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("route", ["riccati", "riccati_struct"])
def test_route_converged_mode_matches_jax(problem, route, mode):
    """The converged mode (``rti=False``) on the route, with SOC (and the
    filter) or with the merit line search, tick for tick against JAX."""
    change = MODES[mode]
    jcfg = JaxSQPConfig(max_iter=20, rti=False, qp_solver=route,
                        kin_backend="xla", mani_grad="analytic",
                        ipm_warm_start=True, ipm_max_iter=25, **change)
    cfg = SQPConfig(max_iter=20, rti=False, qp_solver=route,
                    qp_assembly="xla", **change)
    outs = _loop(problem, cfg, jcfg, TICKS)
    # the mode really iterates: some lane-tick took more than one iteration
    assert max(int(o.sqp_iters.max()) for _, o, _ in outs) > 1


FLEET_ROUTES = ("riccati_pallas", "riccati_struct", "riccati")
FLEET_ASSEMBLY = {"riccati_pallas": (ak, "build_qp_stages_k_kernel"),
                  "riccati_struct": (qps, "build_qp_stages_s"),
                  "riccati": (qps, "build_qp_stages")}


def _fleet_cfg(route, fleet):
    return SQPConfig(max_iter=5, rti=False, qp_solver=route,
                     qp_assembly="pallas" if route == "riccati_pallas"
                     else "xla", fleet_mode=fleet)


@pytest.mark.parametrize("route", FLEET_ROUTES)
def test_fleet_mode_bit_identical(problem, route, monkeypatch):
    """Fleet mode gives the ticks of the early-exit loop bit for bit (the
    port's CPU run of every Riccati route: K1-K4's plain versions on the
    first), and its SQP body runs exactly ``max_iter`` times a tick."""
    name, j, port, x0 = problem
    sys_ = SYSTEMS[name][1]
    module, attr = FLEET_ASSEMBLY[route]
    calls = []
    original = getattr(module, attr)
    monkeypatch.setattr(module, attr,
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    obs = torch.tensor(np.asarray(j["obs"]), dtype=DT).expand(B, 3)
    rad = torch.zeros(B, dtype=DT)
    runs = {}
    for fleet in (False, True):
        calls.clear()
        carry = init_carry(B, DT, "cpu", sys_)
        x = torch.tensor(x0, dtype=DT)
        u = torch.zeros(B, sys_.nu, dtype=DT)
        ticks, counts = [], []
        for _ in range(2):
            n0 = len(calls)
            carry, out = mpc_step(port["track"], port["params"],
                                  port["sel_nn"], port["env_nn"], carry, x,
                                  u, obs, rad, ts=TS,
                                  cfg=_fleet_cfg(route, fleet), system=sys_)
            u = out.u0
            x = sim_time_step(out.x0_updated, u, TS)
            ticks.append((carry, out, x))
            counts.append(len(calls) - n0)
        runs[fleet] = ticks, counts
    (ref, n_ref), (got, n_got) = runs[False], runs[True]
    assert n_got == [5, 5], n_got
    assert max(n_ref) < 5, n_ref
    for (c0, o0, x0_), (c1, o1, x1_) in zip(ref, got):
        assert torch.equal(x0_, x1_)
        for a, b in ((c0, c1), (o0, o1)):
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name),
                                   getattr(b, f.name)), f.name
    assert bool(got[-1][1].ok.all())


@pytest.mark.parametrize("route", ["riccati", "riccati_struct"])
def test_fleet_mode_matches_jax_fleet_tick(problem, route, monkeypatch):
    """JAX's fleet tick (fixed-trip SQP and IPM loops) and the port's,
    tick for tick, in the converged mode with the merit line search; the
    plain IPM runs all ``ipm_max_iter`` trips."""
    jcfg = JaxSQPConfig(max_iter=5, rti=False, qp_solver=route,
                        kin_backend="xla", mani_grad="analytic",
                        ipm_warm_start=True, ipm_max_iter=25,
                        line_search="merit", fleet_mode=True)
    cfg = dataclasses.replace(_fleet_cfg(route, True), line_search="merit")
    calls = []
    original = qp_ipm._newton_loop
    monkeypatch.setattr(
        qp_ipm, "_newton_loop",
        lambda *a: calls.append(a[2]) or original(*a))
    _loop(problem, cfg, jcfg, 2)
    assert calls and all(calls), calls    # every solve: fixed_iters=True


@pytest.mark.parametrize("route", ["admm", "riccati_pallas",
                                   "riccati_struct", "riccati"])
def test_solve_ocp_timed_matches_solve_ocp(route):
    """JAX's timed SQP loops on the port (Panda-only, as JAX's): every
    phase positive, the total at least their sum, and the result of
    `solve_ocp` on the same inputs (the converged mode, three iterations at
    most)."""
    _, _, port, zs, cu, _, rb = _qp_point("panda")
    cfg = SQPConfig(max_iter=3, rti=False, qp_solver=route,
                    qp_assembly="xla", qp_max_iter=100)
    args = (port["track"], rb, port["params"], cfg,
            torch.tensor(zs, dtype=DT), torch.tensor(cu, dtype=DT), TS)
    timed = (sqp_debug.solve_ocp_timed if route == "admm"
             else sqp_debug.solve_ocp_timed_riccati)
    z, status, times, iters = timed(*args)
    ref = sqp.solve_ocp(*args)
    assert torch.equal(z, ref.z)
    assert torch.equal(status, ref.status)
    assert torch.equal(iters, ref.sqp_iters)
    phases = (times.set_qp, times.solve_qp, times.get_alpha)
    assert all(p > 0.0 for p in phases), times
    assert times.total >= sum(phases) and times.set_env == 0.0
    if route != "admm":
        with pytest.raises(ValueError, match="Riccati family"):
            sqp_debug.solve_ocp_timed_riccati(
                *args[:3], dataclasses.replace(cfg, qp_solver="admm"),
                *args[4:])


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_ee_host_fk_matches_jax(system):
    """`ee_position_host` / `ee_orientation_host` of host data: numpy out,
    within 1e-13 of JAX's."""
    jsys, sys_, x_home = SYSTEMS[system]
    rng = np.random.default_rng(4)
    qs = x_home[:sys_.dof][None] + 0.3 * rng.standard_normal((4, sys_.dof))
    port = kin if sys_.base_dof == 0 else kinm
    jmod = jkin if sys_.base_dof == 0 else jkinm
    for q in list(qs) + [x_home[:sys_.dof].tolist()]:
        p = port.ee_position_host(q)
        assert isinstance(p, np.ndarray) and p.dtype == np.float64
        np.testing.assert_allclose(p, np.asarray(jmod.ee_position_host(q)),
                                   rtol=0, atol=1e-13)
        if sys_.base_dof == 0:
            r_ref = np.asarray(jkin.ee_orientation(jnp.asarray(q)))
        else:
            r_ref = np.asarray(jkinm.ee_orientation_host(q))
        np.testing.assert_allclose(port.ee_orientation_host(q), r_ref,
                                   rtol=0, atol=1e-13)
    # batched host data too
    np.testing.assert_allclose(
        port.ee_position_host(qs),
        np.stack([np.asarray(jmod.ee_position_host(q)) for q in qs]),
        rtol=0, atol=1e-13)


def test_only_ipm_interpret_is_not_ported():
    """Every SQPConfig value JAX runs is accepted on both systems (ADMM on
    the Panda), ``ipm_interpret`` None, True and False among them (the
    route of K1-K4, `ops/cuda_build.kernel_route`); a value
    of ``ipm_interpret`` that is not a bool or None, an unknown value and
    the ADMM Husky+Panda raise JAX's ValueError."""
    for sys_ in (PANDA, HUSKY_PANDA):
        for route in ("riccati", "riccati_struct", "riccati_pallas"):
            for change in (dict(), dict(fleet_mode=True),
                           dict(nn_bf16=True), dict(ipm_scheme="mehrotra"),
                           dict(rti=False, max_iter=0),
                           dict(ipm_interpret=True),
                           dict(ipm_interpret=False)):
                sqp.check_supported(SQPConfig(
                    qp_solver=route, qp_assembly="xla", **change), sys_)
        for flag in (None, True, False):
            sqp.check_supported(SQPConfig(ipm_interpret=flag), sys_)
    sqp.check_supported(SQPConfig(qp_solver="admm", qp_assembly="xla",
                                  fleet_mode=True, nn_bf16=True))
    sqp.check_supported(SQPConfig(qp_solver="admm", qp_assembly="xla",
                                  qp_backend="pallas_interpret"))
    for bad in ("yes", 1, 0.0):
        with pytest.raises(ValueError, match="ipm_interpret"):
            sqp.check_supported(SQPConfig(ipm_interpret=bad))
    with pytest.raises(ValueError, match="use qp_solver='riccati'"):
        sqp.check_supported(SQPConfig(qp_solver="admm", qp_assembly="xla"),
                            HUSKY_PANDA)
    with pytest.raises(ValueError, match="qp_solver='dense'"):
        sqp.check_supported(SQPConfig(qp_solver="dense", qp_assembly="xla"))
    assert sqp.constraint_norm is not None
    c = torch.tensor([[0.5, 2.0, -1.0]])
    lo, hi = torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0] * 3])
    assert float(sqp.constraint_norm(c, lo, hi)[0]) == 2.0
    assert float(qp_data.constraint_norm(c, lo, hi)[0]) == 2.0
