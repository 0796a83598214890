"""The port's scenario split (`mpcc_manipulator_tpu_torch.parallel.sharding`)
on the CPU in float64.

* units: the slices for W = 1, 2, 8, an uneven batch, a mesh without a
  process group, a ``devices`` list of the wrong length, the sharded step's
  argument checks;
* the Panda, tests/test_sharding.py's problem and inputs: the port's
  sharded step, run for each of W = 8 ranks in turn, against JAX's
  ``make_sharded_step`` on the 8-device CPU mesh and against the port's
  unsharded step, at that test's 1e-9;
* fleet mode (the packed ``riccati`` route, fixed-trip loops) through the
  sharded step against JAX's on the 8-device mesh at 1e-9, and against
  the port's early-exit tick bit for bit;
* the Husky+Panda, tests/test_mobile_mpcc.py::test_mobile_batched_sharded
  with its assertions, W = 2, against the unsharded tick at 1e-9;
* two real processes over gloo (the Panda, RTI), each on its slice: their
  rows equal the one-process batch's, ``fleet_diagnostics`` equals the
  unsharded means, and the collective audit (the counterpart of
  tests/test_weak_scaling.py) counts no collective in the tick and one
  ``all_reduce`` of at most 24 bytes in ``fleet_diagnostics``.

The two ranks are spawned processes that import this module by name, so
JAX is imported only inside the test that compares with it.
"""

import dataclasses
import multiprocessing
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import MPCCarry
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.parallel import sharding as shd
from mpcc_manipulator_tpu_torch.problem import (X0_HOME, X0_HOME_MOBILE,
                                                build_problem)
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA

torch.set_num_threads(1)

TS = 0.01
DT = torch.float64
TOL = 1e-9              # tests/test_sharding.py:80-81
TWO_PROC_BATCH = 8
TWO_PROC_TICKS = 3
SPAWN_TIMEOUT = 120     # s, per rank's result
# every collective entry point of torch.distributed
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "barrier",
               "monitored_barrier", "gather", "gather_object", "scatter",
               "scatter_object_list", "send", "recv", "isend", "irecv",
               "batch_isend_irecv")


def _scenarios(x0: np.ndarray, system=PANDA):
    """(carry, x0, u0, obs_pos, obs_radius) for the rows of ``x0``: zero
    inputs, the obstacle far away."""
    b = x0.shape[0]
    return (shd.batch_init_carry(b, DT, system, device="cpu"),
            torch.tensor(x0, dtype=DT), torch.zeros(b, system.nu, dtype=DT),
            torch.tensor([[3.0, 3.0, 3.0]], dtype=DT).expand(b, 3).clone(),
            torch.zeros(b, dtype=DT))


def _rows(outs, field):
    return torch.cat([getattr(o, field) for o in outs])


# ------------------------------------------------------------ units


@pytest.mark.parametrize("world", [1, 2, 8])
def test_shard_batch_slices(world):
    rng = np.random.default_rng(world)
    carry, x, u, obs, rad = _scenarios(
        X0_HOME[None] + rng.standard_normal((16, 9)))
    carry = dataclasses.replace(carry, z_guess=torch.tensor(
        rng.standard_normal(tuple(carry.z_guess.shape))))
    tree = (carry, x, u, obs, rad)
    parts = [shd.shard_batch(tree, shd.Mesh(r, world, "cpu"))
             for r in range(world)]
    n = 16 // world
    for r, part in enumerate(parts):
        assert isinstance(part[0], MPCCarry)
        assert part[1].shape == (n, 9) and part[0].ipm_s.shape[0] == n
        torch.testing.assert_close(part[1], x[r * n:(r + 1) * n], rtol=0,
                                   atol=0)
    for f in dataclasses.fields(MPCCarry):
        torch.testing.assert_close(
            torch.cat([getattr(p[0], f.name) for p in parts]),
            getattr(carry, f.name), rtol=0, atol=0)


def test_uneven_batch_raises():
    with pytest.raises(ValueError, match="split evenly"):
        shd.shard_batch(torch.zeros(6, 3), shd.Mesh(1, 4, "cpu"))
    with pytest.raises(ValueError, match="axis"):
        shd.shard_batch(torch.zeros(8, 3), shd.Mesh(0, 2, "cpu"),
                        axis_name="lanes")


def test_mesh_without_group_and_replicate():
    assert not dist.is_initialized()
    mesh = shd.make_mesh(devices=["cpu"])
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="devices for a world of 1"):
        shd.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="outside a world"):
        shd.Mesh(2, 2, "cpu")
    problem = build_problem(DT, "cpu")
    track, params, sel_nn, env_nn = shd.replicate(problem, mesh)
    assert sel_nn is problem[2] and env_nn is problem[3]
    assert params.model.max_dist_proj == problem[1].model.max_dist_proj
    torch.testing.assert_close(track.length, problem[0].length)
    # a mesh of one keeps the whole batch
    scen = _scenarios(np.tile(X0_HOME, (4, 1)))
    torch.testing.assert_close(shd.shard_batch(scen, mesh)[1], scen[1],
                               rtol=0, atol=0)


def test_sharded_step_checks_its_arguments():
    mesh = shd.Mesh(0, 2, "cpu")
    step = shd.make_sharded_step(mesh)
    carry, x, u, obs, rad = _scenarios(np.tile(X0_HOME, (4, 1)))
    problem = build_problem(DT, "cpu")
    with pytest.raises(ValueError, match="leading sizes"):
        step(*problem, carry, x, u[:2], obs, rad)
    with pytest.raises(ValueError, match="on meta"):
        step(*problem, carry, x.to("meta"), u, obs, rad)
    with pytest.raises(ValueError, match="axis"):
        shd.make_sharded_step(mesh, axis_name="lanes")


# ------------------------------------------------------------ against JAX


def test_sharded_step_matches_jax_mesh_and_unsharded():
    """tests/test_sharding.py::test_sharded_step_matches_vmap's problem and
    inputs (the circle track, batch 16, x0 + 0.005 N(0, 1), JAX's default
    converged dense ADMM path with ``max_iter=2, qp_max_iter=50``): JAX on
    the 8-device mesh, the port for each of 8 ranks in turn."""
    import jax
    import jax.numpy as jnp

    from mpcc_manipulator_tpu.config import PANDA_DOF
    from mpcc_manipulator_tpu.models import collision_nn as jcnn
    from mpcc_manipulator_tpu.models import kinematics as jkin
    from mpcc_manipulator_tpu.parallel import sharding as jshd
    from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
    from mpcc_manipulator_tpu.params import load_params as j_load_params
    from mpcc_manipulator_tpu.splines import arc_length as jals
    from mpcc_manipulator_tpu_torch import convert
    from mpcc_manipulator_tpu_torch.params import reference_sqp_config
    from tests.test_sharding import _batch_inputs

    params, _ = j_load_params(dtype=jnp.float64)
    sel_nn = jcnn.load_self_collision_nn(dtype=jnp.float64)
    env_nn = jcnn.load_env_collision_nn(dtype=jnp.float64)
    x0 = jnp.asarray(X0_HOME, dtype=jnp.float64)
    ee = np.asarray(jkin.ee_position(x0[:PANDA_DOF]))
    phi = np.linspace(0, 2 * np.pi, 60)
    track = jals.gen_6d_spline(
        np.zeros(60) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2],
        np.tile(np.asarray(jkin.ee_orientation(x0[:PANDA_DOF])), (60, 1, 1)),
        dtype=jnp.float64)
    batch = 16
    x0_b, u0_b, obs_b, rad_b = _batch_inputs(x0, batch)

    mesh = jshd.make_mesh(jax.devices("cpu")[:8])
    jstep = jshd.make_sharded_step(mesh, ts=TS, cfg=JaxSQPConfig(
        max_iter=2, qp_max_iter=50))
    scen = jshd.shard_batch((jshd.batch_init_carry(batch, jnp.float64),
                             x0_b, u0_b, obs_b, rad_b), mesh)
    _, out_j = jstep(*(jshd.replicate(t, mesh)
                       for t in (track, params, sel_nn, env_nn)), *scen)

    np_tree = lambda t: jax.tree.map(np.asarray, t)
    problem = (convert.track(np_tree(track), device="cpu"),
               convert.mpcc_params(np_tree(params), device="cpu"),
               convert.mlp(np_tree(sel_nn), device="cpu"),
               convert.mlp(np_tree(env_nn), device="cpu"))
    cfg = reference_sqp_config(SQPConfig(max_iter=2, qp_max_iter=50))
    scen_p = (shd.batch_init_carry(batch, DT, device="cpu"),
              *(torch.tensor(np.asarray(a)) for a in
                (x0_b, u0_b, obs_b, rad_b)))
    outs = []
    for r in range(8):
        rank = shd.Mesh(r, 8, "cpu")
        step = shd.make_sharded_step(rank, ts=TS, cfg=cfg)
        outs.append(step(*shd.replicate(problem, rank),
                         *shd.shard_batch(scen_p, rank))[1])
    _, ref = shd.batched_mpc_step(*problem, *scen_p, ts=TS, cfg=cfg)
    for f in ("u0", "x0_updated"):
        got = _rows(outs, f).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(out_j, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)
        np.testing.assert_allclose(got, getattr(ref, f).numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f)
    assert bool(_rows(outs, "ok").all())


def test_fleet_sharded_step_matches_jax_mesh():
    """Fleet mode through the sharded step (tests/test_multihost.py's
    setting: the packed ``riccati`` route, fixed-trip SQP and IPM loops):
    tests/test_sharding.py's problem and inputs, the converged mode with
    the merit line search, JAX on the 8-device mesh against the port's 8
    ranks in turn and its unsharded fleet tick at 1e-9; the fleet tick
    equals the early-exit tick bit for bit, and no rank's tick reads a
    convergence flag on the host (every SQP and IPM loop runs its full
    trips)."""
    import jax
    import jax.numpy as jnp

    from mpcc_manipulator_tpu.config import PANDA_DOF
    from mpcc_manipulator_tpu.models import collision_nn as jcnn
    from mpcc_manipulator_tpu.models import kinematics as jkin
    from mpcc_manipulator_tpu.parallel import sharding as jshd
    from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
    from mpcc_manipulator_tpu.params import load_params as j_load_params
    from mpcc_manipulator_tpu.splines import arc_length as jals
    from mpcc_manipulator_tpu_torch import convert
    from mpcc_manipulator_tpu_torch.params import reference_sqp_config
    from mpcc_manipulator_tpu_torch.solver import qp_ipm
    from tests.test_sharding import _batch_inputs

    params, _ = j_load_params(dtype=jnp.float64)
    sel_nn = jcnn.load_self_collision_nn(dtype=jnp.float64)
    env_nn = jcnn.load_env_collision_nn(dtype=jnp.float64)
    x0 = jnp.asarray(X0_HOME, dtype=jnp.float64)
    ee = np.asarray(jkin.ee_position(x0[:PANDA_DOF]))
    phi = np.linspace(0, 2 * np.pi, 60)
    track = jals.gen_6d_spline(
        np.zeros(60) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2],
        np.tile(np.asarray(jkin.ee_orientation(x0[:PANDA_DOF])), (60, 1, 1)),
        dtype=jnp.float64)
    batch = 16
    x0_b, u0_b, obs_b, rad_b = _batch_inputs(x0, batch)
    change = dict(max_iter=3, qp_solver="riccati", ipm_max_iter=20,
                  line_search="merit", fleet_mode=True)

    mesh = jshd.make_mesh(jax.devices("cpu")[:8])
    jstep = jshd.make_sharded_step(mesh, ts=TS, cfg=JaxSQPConfig(**change))
    scen = jshd.shard_batch((jshd.batch_init_carry(batch, jnp.float64),
                             x0_b, u0_b, obs_b, rad_b), mesh)
    _, out_j = jstep(*(jshd.replicate(t, mesh)
                       for t in (track, params, sel_nn, env_nn)), *scen)

    np_tree = lambda t: jax.tree.map(np.asarray, t)
    problem = (convert.track(np_tree(track), device="cpu"),
               convert.mpcc_params(np_tree(params), device="cpu"),
               convert.mlp(np_tree(sel_nn), device="cpu"),
               convert.mlp(np_tree(env_nn), device="cpu"))
    # JAX's defaults besides the change: the converged mode, the plain
    # kinematics with the fd gradient, a cold interior point
    cfg = SQPConfig(rti=False, qp_assembly="xla", kin_backend="xla",
                    mani_grad="fd", ipm_warm_start=False, **change)
    scen_p = (shd.batch_init_carry(batch, DT, device="cpu"),
              *(torch.tensor(np.asarray(a)) for a in
                (x0_b, u0_b, obs_b, rad_b)))
    flags = []
    loop = qp_ipm._newton_loop
    qp_ipm._newton_loop = lambda *a: flags.append(a[2]) or loop(*a)
    try:
        outs = []
        for r in range(8):
            rank = shd.Mesh(r, 8, "cpu")
            step = shd.make_sharded_step(rank, ts=TS, cfg=cfg)
            outs.append(step(*shd.replicate(problem, rank),
                             *shd.shard_batch(scen_p, rank))[1])
    finally:
        qp_ipm._newton_loop = loop
    assert flags and all(flags)       # every IPM solve: fixed_iters=True
    _, ref = shd.batched_mpc_step(*problem, *scen_p, ts=TS, cfg=cfg)
    _, early = shd.batched_mpc_step(
        *problem, *scen_p, ts=TS, cfg=dataclasses.replace(cfg,
                                                          fleet_mode=False))
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(early, f.name)), \
            f.name
    for f in ("u0", "x0_updated"):
        got = _rows(outs, f).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(out_j, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)
        np.testing.assert_allclose(got, getattr(ref, f).numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f)
    for f in ("ok", "status", "sqp_iters", "qp_iters"):
        np.testing.assert_array_equal(_rows(outs, f).numpy(),
                                      np.asarray(getattr(out_j, f)),
                                      err_msg=f)
    assert bool(_rows(outs, "ok").all())


# ------------------------------------------------------------ Husky+Panda


# tests/test_mobile_mpcc.py's CFG (`SQPConfig(max_iter=25, qp_solver=
# "riccati", ipm_max_iter=30, mani_grad="ad")` over JAX's defaults: the
# converged mode, the plain kinematics, a cold interior point) on the
# port's structured IPM route, the same algorithm as the packed "riccati"
# (held against each other in tests/test_torch_solver_routes.py)
MOBILE_CFG = SQPConfig(rti=False, max_iter=25, ipm_max_iter=30,
                       mani_grad="ad", kin_backend="xla", qp_assembly="xla",
                       ipm_warm_start=False)


def test_mobile_batched_sharded():
    """tests/test_mobile_mpcc.py::test_mobile_batched_sharded on two ranks
    in turn: batch 16, 8 ticks with the plant step; every lane solves and
    progresses, and the split equals the unsharded tick."""
    sys_ = HUSKY_PANDA
    batch, world = 16, 2
    problem = build_problem(DT, "cpu", system=sys_)
    rng = np.random.default_rng(0)
    x0 = X0_HOME_MOBILE[None] + 0.02 * rng.standard_normal((batch, sys_.nx))
    x0[:, sys_.s_idx] = 0.0
    x0[:, sys_.vs_idx] = 0.0
    meshes = [shd.Mesh(r, world, "cpu") for r in range(world)]
    steps = [shd.make_sharded_step(m, ts=TS, cfg=MOBILE_CFG, system=sys_)
             for m in meshes]
    full = _scenarios(x0, sys_)
    shards = [list(shd.shard_batch(full, m)) for m in meshes]
    carry, x, u, obs, rad = full
    for _ in range(8):
        outs = []
        for s, step in zip(shards, steps):
            s[0], out = step(*problem, *s)
            s[2] = out.u0
            s[1] = sim_time_step(out.x0_updated, out.u0, TS)
            outs.append(out)
        carry, ref = shd.batched_mpc_step(*problem, carry, x, u, obs, rad,
                                          ts=TS, cfg=MOBILE_CFG, system=sys_)
        u = ref.u0
        x = sim_time_step(ref.x0_updated, u, TS)
        for f in ("u0", "x0_updated"):
            torch.testing.assert_close(_rows(outs, f), getattr(ref, f),
                                       rtol=TOL, atol=TOL)
    ok = _rows(outs, "ok")
    assert bool(ok.all()), _rows(outs, "status")
    x_s = torch.cat([s[1] for s in shards])
    torch.testing.assert_close(x_s, x, rtol=TOL, atol=TOL)
    s_vals = x_s[:, sys_.s_idx].numpy()
    assert (s_vals > -1e-6).all()
    assert s_vals.mean() > 1e-3 and (s_vals > 1e-4).sum() >= batch // 2
    assert np.std(x_s[:, 0].numpy()) > 0


# ------------------------------------------------------------ two processes


def _panda_start(batch: int) -> np.ndarray:
    """The home state + 0.01 N(0, 1), seed 0, s and vs made non-negative."""
    rng = np.random.default_rng(0)
    x0 = X0_HOME[None] + 0.01 * rng.standard_normal((batch, 9))
    x0[:, 7:] = np.abs(x0[:, 7:])
    return x0


def _count_collectives() -> list:
    """Wrap every collective of torch.distributed (its module and
    distributed_c10d) with a counter; returns the list each call appends
    ``(name, tensor bytes)`` to."""
    from torch.distributed import distributed_c10d as c10d
    calls = []
    for name in COLLECTIVES:
        orig = getattr(c10d, name, None)
        if orig is None:
            continue

        def counted(*args, _name=name, _orig=orig, **kwargs):
            held = [a for a in (*args, *kwargs.values())
                    if isinstance(a, torch.Tensor)]
            calls.append((_name, sum(t.numel() * t.element_size()
                                     for t in held)))
            return _orig(*args, **kwargs)

        for mod in (dist, c10d):
            if hasattr(mod, name):
                setattr(mod, name, counted)
    return calls


def _run_rank(world: int) -> dict:
    """This rank's ticks of the Panda's RTI loop on its slice, audited."""
    calls = _count_collectives()
    mesh = shd.make_mesh(devices=["cpu"] * world)
    problem = shd.replicate(build_problem(DT, "cpu"), mesh)
    carry, x, u, obs, rad = shd.shard_batch(
        _scenarios(_panda_start(TWO_PROC_BATCH)), mesh)
    step = shd.make_sharded_step(mesh, ts=TS, cfg=SQPConfig())
    us, xs, tick_calls = [], [], []
    for _ in range(TWO_PROC_TICKS):
        calls.clear()
        carry, out = step(*problem, carry, x, u, obs, rad)
        tick_calls.append(list(calls))
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        us.append(u.numpy())
        xs.append(x.numpy())
    calls.clear()
    diag = shd.fleet_diagnostics(out.ok, out.sqp_iters, mesh)
    return dict(rank=mesh.rank, u=np.stack(us), x=np.stack(xs),
                ok=out.ok.numpy(), tick_calls=tick_calls,
                diag_calls=list(calls),
                diag={k: float(v) for k, v in diag.items()})


def _gloo_worker(rank: int, world: int, init_file: str, results) -> None:
    """One spawned rank: joins the gloo group, runs, sends its result (or
    its traceback) back."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            results.put((rank, _run_rank(world)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def test_two_gloo_ranks_match_one_process(tmp_path):
    world = 2
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, world, str(tmp_path / "pg"), results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        # the one-process batch, while the ranks start
        problem = build_problem(DT, "cpu")
        carry, x, u, obs, rad = _scenarios(_panda_start(TWO_PROC_BATCH))
        us, xs = [], []
        for _ in range(TWO_PROC_TICKS):
            carry, out = shd.batched_mpc_step(*problem, carry, x, u, obs,
                                              rad, ts=TS, cfg=SQPConfig())
            u = out.u0
            x = sim_time_step(out.x0_updated, u, TS)
            us.append(u.numpy())
            xs.append(x.numpy())
        ref_diag = shd.fleet_diagnostics(out.ok, out.sqp_iters)
        got = {}
        for _ in range(world):
            try:
                rank, res = results.get(timeout=SPAWN_TIMEOUT)
            except queue.Empty:
                pytest.fail(f"a rank sent nothing in {SPAWN_TIMEOUT} s")
            assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * world

    n = TWO_PROC_BATCH // world
    for r, res in got.items():
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(res["u"], np.stack(us)[:, rows],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["x"], np.stack(xs)[:, rows],
                                   rtol=TOL, atol=TOL)
        assert res["ok"].all()
        # the audit: no collective in any tick, one all_reduce of <= 24
        # bytes in fleet_diagnostics
        assert res["tick_calls"] == [[]] * TWO_PROC_TICKS, res["tick_calls"]
        assert [c for c, _ in res["diag_calls"]] == ["all_reduce"]
        assert 0 < res["diag_calls"][0][1] <= 24, res["diag_calls"]
        # integer sums over the fleet: exactly the unsharded means
        assert res["diag"] == {k: float(v) for k, v in ref_diag.items()}
