"""The port's MPCC tick (`mpcc_manipulator_tpu_torch.mpc.mpc_step`) against
the JAX package's `mpc_step`, closed loop, float64 on the CPU.

The JAX side runs its plain path of the same algorithm (structured IPM,
XLA kinematics, analytic manipulability gradient, RTI with warm-started
interior point), one single-scenario call per lane so that it compiles
once; the port runs the four lanes as one batch through its plain
versions (CPU tensors).  Both packages compute on identical parameters,
track and network weights (carried over by ``convert``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME

torch.set_num_threads(1)

TS = 0.01
N_TICKS = 15
BATCH = 4
# float64 closed loop: the two implementations differ only in summation
# order, so states agree to roundoff amplified over 15 ticks
STATE_TOL = 1e-8

JAX_CFG = JaxSQPConfig(max_iter=1, rti=True, qp_solver="riccati_struct",
                       kin_backend="xla", mani_grad="analytic",
                       ipm_warm_start=True, ipm_max_iter=25)


@pytest.fixture(scope="module")
def problem():
    from __graft_entry__ import _build_problem
    track, params, _, sel_nn, env_nn, carry, _, u0, obs = _build_problem(
        jnp.float64, small=False)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    port = dict(track=convert.track(np_tree(track), device="cpu"),
                params=convert.mpcc_params(np_tree(params), device="cpu"),
                sel_nn=convert.mlp(np_tree(sel_nn), device="cpu"),
                env_nn=convert.mlp(np_tree(env_nn), device="cpu"))
    rng = np.random.default_rng(7)
    x0 = X0_HOME[None] + 0.01 * rng.standard_normal((BATCH, 9))
    x0[:, 7:] = np.abs(x0[:, 7:])
    return (track, params, sel_nn, env_nn, carry, u0, obs), port, x0


def _closed_loop_matches_jax(problem, cfg, jax_cfg):
    """The port's ``mpc_step`` under ``cfg`` against JAX ``mpc_step`` under
    ``jax_cfg``, tick for tick: status, IPM iterations and states."""
    (track, params, sel_nn, env_nn, carry0, u0, obs), port, x0 = problem
    step = jax.jit(lambda c, x, u: jax_mpc_step(
        track, params, sel_nn, env_nn, c, x, u, obs,
        jnp.asarray(0.0, jnp.float64), ts=TS, cfg=jax_cfg))

    carries = [carry0] * BATCH
    xj = [jnp.asarray(x0[i]) for i in range(BATCH)]
    uj = [u0] * BATCH
    dt = torch.float64
    carry = init_carry(BATCH, dt, "cpu")
    x = torch.tensor(x0, dtype=dt)
    u = torch.zeros(BATCH, 8, dtype=dt)
    obs_t = torch.tensor(np.asarray(obs), dtype=dt).expand(BATCH, 3)
    rad = torch.zeros(BATCH, dtype=dt)
    for t in range(N_TICKS):
        carry, out = mpc_step(port["track"], port["params"], port["sel_nn"],
                              port["env_nn"], carry, x, u, obs_t, rad,
                              ts=TS, cfg=cfg)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        for i in range(BATCH):
            carries[i], oj = step(carries[i], xj[i], uj[i])
            uj[i] = oj.u0
            xj[i] = jdyn.sim_time_step(oj.x0_updated, oj.u0, TS)
            assert bool(out.ok[i]) == bool(oj.ok), (t, i)
            assert int(out.status[i]) == int(oj.status), (t, i)
            assert int(out.qp_iters[i]) == int(oj.qp_iters), (t, i)
        x_ref = np.stack([np.asarray(v) for v in xj])
        gap = float(np.abs(x.numpy() - x_ref).max())
        assert gap < STATE_TOL, (t, gap)
    assert bool(out.ok.all())
    # the loop made progress along the track
    assert float(x[:, 7].min()) > float(torch.tensor(x0[:, 7]).min())


def test_mpc_step_matches_jax_closed_loop(problem):
    _closed_loop_matches_jax(problem, SQPConfig(), JAX_CFG)


def test_mehrotra_mpc_step_matches_jax_closed_loop(problem):
    """Mehrotra's centering (the plain route, which is K1's plain version)
    against JAX's structured Mehrotra IPM."""
    import dataclasses
    _closed_loop_matches_jax(
        problem, SQPConfig(ipm_scheme="mehrotra", qp_assembly="xla"),
        dataclasses.replace(JAX_CFG, ipm_scheme="mehrotra"))


def test_rti_passes_oracle_conformance_gate():
    """The port's RTI closed loop against the converged numpy oracle, 100
    ticks, float64, held to the envelope of the JAX package's gate
    (tests/test_rti.py) at that gate's IPM settings: cold interior-point
    start, at most 40 Newton iterations.  (With the slice's interior-point
    warm start both packages reach worst_q 8.5e-4 on this loop.)"""
    import tests.test_conformance_oracle as tco
    from tests.oracle import nlp, solver as osol
    params, track, tr_o, p_o, sel_o, env_o, sel_j, env_j = \
        tco.setup.__wrapped__()
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    ptrack = convert.track(np_tree(track), device="cpu")
    pparams = convert.mpcc_params(np_tree(params), device="cpu")
    psel = convert.mlp(np_tree(sel_j), device="cpu")
    penv = convert.mlp(np_tree(env_j), device="cpu")
    cfg = SQPConfig(ipm_warm_start=False, ipm_max_iter=40)
    mpc_o = osol.OracleMPC(tr_o, p_o, sel_o, env_o, ts=tco.TS)
    dt = torch.float64
    carry = init_carry(1, dt, "cpu")
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=dt)
    rad = torch.zeros(1, dtype=dt)
    x_o, u_o = tco.X0.copy(), np.zeros(8)
    x_p, u_p = torch.tensor(tco.X0[None]), torch.zeros(1, 8, dtype=dt)
    worst = np.zeros(3)
    for i in range(100):
        ok_o, x_upd, u_o, _, _ = mpc_o.step(x_o, u_o)
        x_o = nlp.sim_time_step(x_upd, u_o, tco.TS)
        carry, out = mpc_step(ptrack, pparams, psel, penv, carry, x_p, u_p,
                              obs, rad, ts=tco.TS, cfg=cfg)
        u_p = out.u0
        x_p = torch.tensor(nlp.sim_time_step(
            out.x0_updated[0].numpy(), u_p[0].numpy(), tco.TS))[None]
        assert ok_o and bool(out.ok[0]), i
        d = np.abs(x_o - x_p[0].numpy())
        worst = np.maximum(worst, [d[:7].max(), d[7], d[8]])
    assert worst[0] < 7.5e-4, worst
    assert worst[1] < 2.5e-4, worst
    assert worst[2] < 4e-3, worst
    assert x_o[7] > 0.15 and float(x_p[0, 7]) > 0.15


@pytest.mark.parametrize("change", [
    dict(ipm_interpret="True"), dict(ipm_interpret=1),
    dict(qp_backend="pallas_gpu"), dict(kin_backend="cuda")],
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_off_slice_settings_raise(change):
    """A value JAX's ``SQPConfig`` has not raises ``ValueError`` naming
    the setting; none is ignored.  Every value JAX has runs
    (``ipm_interpret`` is None, True or False, ``qp_backend`` also
    ``"pallas_interpret"``).  (The plain assembly is the base: with the
    kernel assembly, a solver other than 'riccati_pallas' raises the JAX
    package's ValueError first.)"""
    import dataclasses
    from mpcc_manipulator_tpu_torch.solver.sqp import check_supported
    check_supported(SQPConfig())
    with pytest.raises(ValueError, match=next(iter(change))):
        check_supported(dataclasses.replace(SQPConfig(qp_assembly="xla"),
                                            **change))


@pytest.mark.parametrize("change", [
    dict(qp_assembly="pallas"), dict(do_SOC=True), dict(line_search="merit"),
    dict(rti=False), dict(qp_solver="admm"),
    dict(qp_solver="admm", use_BFGS=True), dict(ipm_scheme="mehrotra"),
    dict(mani_grad="fd", kin_backend="xla"), dict(kin_backend="xla"),
    dict(fleet_mode=True), dict(nn_bf16=True), dict(qp_solver="riccati"),
    dict(qp_solver="riccati_struct"), dict(ipm_interpret=True),
    dict(ipm_interpret=False),
    dict(qp_solver="admm", qp_backend="pallas_interpret")],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_slice_settings_are_supported(change):
    """The kernel assembly route, SOC, the merit line search, the converged
    mode, the dense ADMM path with BFGS, Mehrotra's centering, the plain
    kinematics route with the finite-difference manipulability gradient,
    fleet mode, the bf16 NN GEMMs, the packed and structured solver routes
    and the interpret routes run in the port (the kernel routes are the
    default)."""
    import dataclasses
    from mpcc_manipulator_tpu_torch.solver.sqp import check_supported
    check_supported(dataclasses.replace(SQPConfig(qp_assembly="xla"),
                                        **change))


def test_warm_start_helpers_match_jax():
    """Horizon shift (with the x[N-1] <- x[N-2] quirk), cold start and the
    s unwrap, float64."""
    from mpcc_manipulator_tpu import mpc as jmpc
    from mpcc_manipulator_tpu_torch import mpc as pmpc
    rng = np.random.default_rng(9)
    z = rng.standard_normal((3, 179))
    x0 = rng.standard_normal((3, 9))
    ref = jax.vmap(lambda a, b: jmpc._unwrap_s(
        jmpc._shift_warm_start(a, b, TS), 0.5))(jnp.asarray(z),
                                                 jnp.asarray(x0))
    got = pmpc._unwrap_s(pmpc._shift_warm_start(
        torch.tensor(z), torch.tensor(x0), TS), torch.tensor(0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    ref = jax.vmap(lambda b: jmpc._cold_start(b, jnp.float64))(
        jnp.asarray(x0))
    assert np.array_equal(pmpc._cold_start(torch.tensor(x0)).numpy(),
                          np.asarray(ref))


def test_build_problem_matches_jax(problem):
    """The port's own problem builder gives the JAX builder's track,
    parameters and networks."""
    from mpcc_manipulator_tpu_torch.problem import build_problem
    _, port, _ = problem
    track, params, sel_nn, env_nn = build_problem(torch.float64, "cpu")
    for name in ("sx", "sy", "sz", "sr"):
        mine, ref = getattr(track, name), getattr(port["track"], name)
        for f in ("a", "b", "c", "d", "r", "omega"):
            if hasattr(ref, f):
                np.testing.assert_allclose(getattr(mine, f).numpy(),
                                           getattr(ref, f).numpy(),
                                           rtol=0, atol=1e-12)
    np.testing.assert_allclose(track.s_knots.numpy(),
                               port["track"].s_knots.numpy(), rtol=0,
                               atol=1e-12)
    assert torch.equal(params.cost.q_c, port["params"].cost.q_c)
    for a, b in zip(env_nn.layers, port["env_nn"].layers):
        assert torch.equal(a.weight, b.weight)


def _entry_points():
    """(name, call(device-kwargs)) for each entry point that places
    tensors; the convert functions read CPU objects built by the port; a
    compat class gives the tensors its inputs become."""
    import types
    from mpcc_manipulator_tpu_torch import api, compat
    from mpcc_manipulator_tpu_torch import mpc as pmpc
    from mpcc_manipulator_tpu_torch import params as pparams
    from mpcc_manipulator_tpu_torch import problem as pproblem
    from mpcc_manipulator_tpu_torch.models import collision_nn as pcnn
    from mpcc_manipulator_tpu_torch.splines import arc_length as pals
    from mpcc_manipulator_tpu_torch.splines import cubic, rotation
    from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA
    dt = torch.float64
    x = np.linspace(0.0, 1.0, 6)
    rots = np.tile(np.eye(3), (6, 1, 1))
    net = pcnn.load_self_collision_nn(dt, device="cpu")
    src = types.SimpleNamespace(weights=[l.weight.numpy() for l in net.layers],
                                biases=[l.bias.numpy() for l in net.layers])
    cpu = lambda: pproblem.build_problem(dt, device="cpu")
    return {
        "build_problem": lambda **d: pproblem.build_problem(dt, **d),
        "build_problem[husky_panda]": lambda **d: pproblem.build_problem(
            dt, system=HUSKY_PANDA, **d),
        "load_params": lambda **d: pparams.load_params(dtype=dt, **d),
        "init_carry": lambda **d: pmpc.init_carry(2, dt, **d),
        "CollisionMLP": lambda **d: pcnn.CollisionMLP(
            src.weights, src.biases, dt, **d),
        "load_self_collision_nn": lambda **d: pcnn.load_self_collision_nn(
            dt, **d),
        "load_env_collision_nn": lambda **d: pcnn.load_env_collision_nn(
            dt, **d),
        "gen_6d_spline": lambda **d: pals.gen_6d_spline(
            x, x ** 2, np.sin(x), rots, dt, **d),
        "CubicSplineCoeffs.from_fit": lambda **d:
            cubic.CubicSplineCoeffs.from_fit(x, np.sin(x), dt, **d),
        "RotSplineCoeffs.from_knots": lambda **d:
            rotation.RotSplineCoeffs.from_knots(x, rots, dt, **d),
        "convert.mlp": lambda **d: convert.mlp(src, dt, **d),
        "convert.mpcc_params": lambda **d: convert.mpcc_params(
            cpu()[1], dt, **d),
        "convert.track": lambda **d: convert.track(cpu()[0], dt, **d),
        "convert.carry": lambda **d: convert.carry(
            pmpc.init_carry(2, dt, "cpu"), dt, **d),
        "convert.stage_qpk": lambda **d: convert.stage_qpk(
            _cpu_stage_qpk(cpu()), dt, **d),
        "api.MPCC": lambda **d: api.MPCC(**d),
        "api.MPCC.setTrack": lambda **d: _with_track(api.MPCC(**d)),
        "compat.RobotModel": lambda **d: compat.RobotModel(**d)._q(
            X0_HOME[:7]),
        "compat.SelfCollisionNN": lambda **d: _loaded(
            compat.SelfCollisionNN(**d), 7),
        "compat.EnvCollisionNN": lambda **d: _loaded(
            compat.EnvCollisionNN(**d), 10),
        "compat.Integrator": lambda **d: compat.Integrator(**d)._xu(
            X0_HOME, np.zeros(8)),
    }


def _with_track(mpc):
    mpc.setTrack(X0_HOME)
    return mpc


def _loaded(net, n_in):
    net.setNeuralNetwork(n_in, None, None, True)
    return net._net


def _cpu_stage_qpk(problem):
    """The StageQPK of the cold start at the home state, on the CPU."""
    from mpcc_manipulator_tpu_torch.mpc import _cold_start
    from mpcc_manipulator_tpu_torch.ocp import qp_data, qp_stages
    from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
    track, params, sel_nn, env_nn = problem
    z = _cold_start(torch.tensor(X0_HOME[None]))
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.tensor([[3.0, 3.0, 3.0]], dtype=z.dtype),
                            torch.zeros(1, dtype=z.dtype), sel_nn, env_nn,
                            mani_grad="analytic", kin_backend="pallas")
    return qp_stages.build_qp_stages_k(track, z, rb, params,
                                       torch.zeros(1, 8, dtype=z.dtype), TS)


ENTRY_POINTS = ["build_problem", "build_problem[husky_panda]", "load_params",
                "init_carry", "CollisionMLP",
                "load_self_collision_nn", "load_env_collision_nn",
                "gen_6d_spline", "CubicSplineCoeffs.from_fit",
                "RotSplineCoeffs.from_knots", "convert.mlp",
                "convert.mpcc_params", "convert.track", "convert.carry",
                "convert.stage_qpk", "api.MPCC", "api.MPCC.setTrack",
                "compat.RobotModel", "compat.SelfCollisionNN",
                "compat.EnvCollisionNN", "compat.Integrator"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    """Each entry point places its tensors on the CUDA device unless the
    caller asks for the CPU: without a GPU the default call raises (no
    quiet CPU fallback), and ``device="cpu"`` runs."""
    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, torch.nn.Module):
            yield from obj.parameters()
        elif isinstance(obj, (tuple, list)):
            for o in obj:
                yield from tensors(o)
        elif hasattr(obj, "__dataclass_fields__"):
            for f in obj.__dataclass_fields__:
                yield from tensors(getattr(obj, f))
        elif type(obj).__module__.startswith("mpcc_manipulator_tpu_torch"):
            for v in vars(obj).values():
                yield from tensors(v)

    call = _entry_points()[name]
    on_cpu = list(tensors(call(device="cpu")))
    assert on_cpu and all(t.device.type == "cpu" for t in on_cpu)
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in tensors(call()))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
