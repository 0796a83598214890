"""The JAX package's nominal closed-loop gates held for the port, float64
on the CPU, through the runners of `mpcc_manipulator_tpu_torch/gates.py`
(one lane from the exact home state; the card runs the same runners on 8
lanes in float32), and the numpy-oracle gates
(`tests/test_conformance_oracle.py`):

* RTI against the converged mode, 60 ticks (`tests/test_rti.py:36`);
* the BASELINE config ladder and the runtime override
  (`tests/test_config_ladder.py:58-90`);
* the dense QP against the numpy oracle at three iterates (`:60`) and the
  100-tick converged closed loop against the oracle (`:96`, slow);
* the repo's track to the end point in float64 and float32
  (`tests/test_track_completion.py:71`, `:85`, slow) and the DYROS letter
  track (`tests/test_letter_track.py:27`, slow), and the letter track
  generator's geometry (`tests/test_splines.py:143`).

The solver is the port's structured interior-point route (JAX's gates run
the packed `qp_solver="riccati"`, which the port leaves out; the
structured IPM is the same algorithm as JAX's `riccati_struct`).  The
thresholds and the `slow` markings are JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu_torch import convert, gates
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp import qp_data
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.splines import arc_length as als

torch.set_num_threads(1)

DT = torch.float64


def test_rti_matches_converged_closed_loop():
    r = gates.rti_vs_converged(DT, "cpu", lanes=1)
    assert r["max_dq"] < 1e-4 and r["max_ds"] < 1e-4
    r = gates.rti_vs_converged_jax_route(DT, "cpu", lanes=1)
    assert r["max_dq"] < 1e-4 and r["max_ds"] < 1e-4


def test_rti_vs_converged_on_the_card_starts():
    """The card's A/B contract on its 8 starts, float64 on the CPU: the
    exact home state within 1e-4, and each lane that leaves it one whose
    tick-0 second step passed the filter on a rounding-level fall of the
    violation (`gates.roundoff_steps`)."""
    r = gates.rti_vs_converged(DT, "cpu", lanes=gates.LANES)
    assert r["max_dq"] <= gates.AB_JAX_F32_FIGURE
    for lane, (v1, v2) in zip(r["roundoff_lanes"], r["tick0_vio"]):
        assert v2 < v1 < gates.VIO_ROUNDOFF * np.finfo(np.float64).eps, lane


def _jax_ab(dt, qp_solver: str) -> dict:
    """The JAX package's A/B (`test_rti.py:36`: the converged
    `max_iter=20` against `max_iter=1, rti=True`, 60 ticks) on the card's 8
    starts: per lane the largest |dq| and |ds|, and the filter's tick-0
    values in the form `gates.roundoff_steps` reads (JAX's own objective
    and l1 violation at the RTI run's and the converged run's tick-0
    iterates, on the tick's RobotData)."""
    import jax.numpy as jnp
    from __graft_entry__ import _build_problem
    from mpcc_manipulator_tpu.models import dynamics as jdyn
    from mpcc_manipulator_tpu.mpc import _cold_start, _unwrap_s
    from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
    from mpcc_manipulator_tpu.mpc import mpc_step as j_mpc_step
    from mpcc_manipulator_tpu.ocp import qp_data as jqp
    from mpcc_manipulator_tpu.ocp.robot_data import (
        compute_robot_data as j_robot_data)
    from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
    from mpcc_manipulator_tpu.solver.sqp import constraint_norm
    track, params, _, sel, env, _, _, _, obs = _build_problem(dt, small=False)
    x0 = gates.home_states(gates.LANES, DT, "cpu").numpy().astype(dt)
    full = JaxSQPConfig(max_iter=20, qp_solver=qp_solver, ipm_max_iter=25)
    states, tick0 = [], []
    for cfg in (full, JaxSQPConfig(max_iter=1, rti=True, qp_solver=qp_solver,
                                   ipm_max_iter=25)):
        def one(c, x, u, cfg=cfg):
            c, o = j_mpc_step(track, params, sel, env, c, x, u, obs,
                              jnp.asarray(0.0, dt), ts=gates.TS, cfg=cfg)
            return c, jdyn.sim_time_step(o.x0_updated, o.u0, gates.TS), \
                o.u0, o.ok, o.x0_updated
        step = jax.jit(jax.vmap(one))
        c = jax.vmap(lambda _: j_init_carry(dt))(jnp.arange(gates.LANES))
        x, u = jnp.asarray(x0), jnp.zeros((gates.LANES, 8), dt)
        xs = []
        for t in range(60):
            c, x, u, ok, x_upd = step(c, x, u)
            assert bool(ok.all())
            if t == 0:
                tick0.append((x_upd, c.z_guess))
            xs.append(np.asarray(x))
        states.append(np.stack(xs, 1))

    def filter_values(x_upd, z):
        z0 = _unwrap_s(_cold_start(x_upd, dt), track.length)
        rb = j_robot_data(jqp.split_z(z0)[0][:, :7], obs,
                          jnp.asarray(0.0, dt), sel, env,
                          mani_grad=full.mani_grad,
                          kin_backend=full.kin_backend)
        u0 = jnp.zeros(8, dt)
        obj = jqp.total_objective(track, z, rb, params, False)
        constr, lo, hi = jqp.constraint_values(track, z, rb, params, u0,
                                               gates.TS)
        return obj, constraint_norm(constr, lo, hi)

    values = jax.jit(jax.vmap(filter_values))
    x_upd = tick0[1][0]
    o1, v1 = values(x_upd, tick0[1][1])
    o2, v2 = values(x_upd, tick0[0][1])
    d = np.abs(states[0] - states[1])
    return dict(dq=d[..., :7].max(axis=(1, 2)), ds=d[..., 7].max(axis=1),
                obj_first=np.asarray(o1), obj_second=np.asarray(o2),
                vio_first=np.asarray(v1), vio_second=np.asarray(v2))


def test_rti_vs_converged_float32_figure_of_jax():
    """The float32 figure the card's A/B gate holds q to: the JAX package's
    own float32 kernel route (`riccati_pallas` in interpret mode, as
    `tests/test_track_completion.py:85` runs it; the converged
    `max_iter=20` against `max_iter=1, rti=True`) on the card's 8 starts
    misses `test_rti.py`'s 1e-4 in q on 7 of them, the exact home state
    included, at a largest |dq| of 3.1986e-4 (`gates.AB_JAX_F32_FIGURE`);
    s stays within 1e-4."""
    import jax.numpy as jnp
    r = _jax_ab(jnp.float32, "riccati_pallas")
    dq_lane = r["dq"]
    dq, ds = float(dq_lane.max()), float(r["ds"].max())
    assert gates.AB_TOL < dq <= gates.AB_JAX_F32_FIGURE, dq
    # 7 of the 8 lanes miss 1e-4, the exact home state (the JAX test's
    # own start) among them
    assert int((dq_lane > gates.AB_TOL).sum()) == 7, dq_lane
    assert dq_lane[0] > gates.AB_TOL, dq_lane
    assert ds < 1e-4, ds


def test_rti_vs_converged_float64_figure_of_jax():
    """The JAX test's own settings (`test_rti.py:33-34`: packed
    `qp_solver="riccati"`, float64) on the card's 8 starts: the exact home
    state holds 1e-4 in q and s, and a perturbed lane leaves it in s
    (lane 1: |ds| 2.918e-4): its converged run's tick-0 second step raised
    JAX's objective and passed JAX's filter on a rounding-level fall of the
    violation, the `gates.roundoff_steps` rule the port's A/B applies."""
    import jax.numpy as jnp
    r = _jax_ab(jnp.float64, "riccati")
    over = (r["dq"] >= gates.AB_TOL) | (r["ds"] >= gates.AB_TOL)
    assert not over[0], (r["dq"], r["ds"])
    assert float(r["ds"].max()) > gates.AB_TOL, r["ds"]
    assert (gates.roundoff_steps(r, DT) >= over).all(), r


@pytest.fixture(scope="module")
def ladder_base():
    return gates.circle_track(DT, "cpu"), gates.home_states(1, DT, "cpu")


@pytest.mark.parametrize("rung", [r[0] for r in gates.LADDER])
def test_config_ladder(ladder_base, rung):
    gates.ladder_rung(rung, *ladder_base)


def test_runtime_param_override_changes_behavior(ladder_base):
    gates.ladder_override(*ladder_base)


def _port_oracle_setup():
    import tests.test_conformance_oracle as tco
    params, track, tr_o, p_o, sel_o, env_o, sel_j, env_j = \
        tco.setup.__wrapped__()
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    port = (convert.track(np_tree(track), device="cpu"),
            convert.mpcc_params(np_tree(params), device="cpu"),
            convert.mlp(np_tree(sel_j), device="cpu"),
            convert.mlp(np_tree(env_j), device="cpu"))
    return tco, port, (tr_o, p_o, sel_o, env_o)


def _masked(v):
    v = np.asarray(v, dtype=np.float64)
    return np.where(np.abs(v) > 1e20, np.sign(v) * 1e30, v)


def test_qp_assembly_matches_oracle():
    """The port's dense QP (`ocp/qp_data.build_qp` on `compute_robot_data`,
    plain route) against the independent numpy oracle at three random
    iterates, with the JAX test's tolerances (1e-8 / 1e-9)."""
    from tests.oracle import nlp
    tco, (track, params, sel, env), (tr_o, p_o, sel_o, env_o) = \
        _port_oracle_setup()
    rng = np.random.default_rng(42)
    obs = np.array([0.5, 0.0, 0.6])
    rad = 0.05
    u_cur = 0.1 * rng.standard_normal(8)
    for _ in range(3):
        z = np.concatenate([np.tile(tco.X0, 11), np.zeros(80)])
        z[:99] += 0.02 * rng.standard_normal(99)
        xs = z[:99].reshape(11, 9)
        xs[:, 7] = np.sort(np.abs(0.05 * rng.standard_normal(11)))
        xs[:, 8] = 0.1 * rng.standard_normal(11)
        z[99:] = 0.1 * rng.standard_normal(80)
        rbs = [nlp.KnotData(xs[k, :7], sel_o, env_o, obs, rad)
               for k in range(11)]
        h_o, g_o, a_o, l_o, u_o, obj_o, c_o = nlp.build_dense_qp(
            tr_o, p_o, z, rbs, u_cur, tco.TS)
        t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))[None]
        rb = compute_robot_data(t(xs[:, :7]), t(obs), t([rad])[0], sel, env,
                                mani_grad="fd", kin_backend="xla")
        h_p, g_p, a_p, l_p, u_p, obj_p, c_p = [
            v[0].numpy() for v in qp_data.build_qp(
                track, t(z), rb, params, t(u_cur), tco.TS)]
        np.testing.assert_allclose(h_o, h_p, atol=1e-8, rtol=1e-8)
        np.testing.assert_allclose(g_o, g_p, atol=1e-8, rtol=1e-8)
        np.testing.assert_allclose(a_o, a_p, atol=1e-9, rtol=1e-9)
        np.testing.assert_allclose(_masked(l_o), _masked(l_p), atol=1e-9)
        np.testing.assert_allclose(_masked(u_o), _masked(u_p), atol=1e-9)
        np.testing.assert_allclose(c_o, c_p, atol=1e-9)
        assert abs(obj_o - float(obj_p)) < 1e-8 * max(1.0, abs(obj_o))


@pytest.mark.slow
def test_closed_loop_matches_oracle():
    """100 converged ticks on the repo's track against the oracle's own
    closed loop, JAX's envelope (q 7.5e-4, s 2.5e-4, vs 4e-3) at the JAX
    test's settings: `max_iter=100`, `ipm_max_iter=40`, and JAX's defaults
    for the rest, a cold interior point and the finite-difference
    manipulability gradient on the plain kinematics (the oracle's own
    gradient; with the analytic one the first ticks leave the envelope,
    in JAX as in the port: s 2.96e-4, vs 1.34e-2)."""
    from tests.oracle import nlp, solver as osol
    tco, (track, params, sel, env), (tr_o, p_o, sel_o, env_o) = \
        _port_oracle_setup()
    cfg = SQPConfig(rti=False, max_iter=100, ipm_max_iter=40,
                    ipm_warm_start=False, mani_grad="fd", kin_backend="xla")
    mpc_o = osol.OracleMPC(tr_o, p_o, sel_o, env_o, ts=tco.TS)
    carry = init_carry(1, DT, "cpu")
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=DT)
    rad = torch.zeros(1, dtype=DT)
    x_o, u_o = tco.X0.copy(), np.zeros(8)
    x_p, u_p = torch.tensor(tco.X0[None]), torch.zeros(1, 8, dtype=DT)
    worst = np.zeros(3)
    for i in range(100):
        ok_o, x_upd, u_o, _, st_o = mpc_o.step(x_o, u_o)
        x_o = nlp.sim_time_step(x_upd, u_o, tco.TS)
        carry, out = mpc_step(track, params, sel, env, carry, x_p, u_p, obs,
                              rad, ts=tco.TS, cfg=cfg)
        u_p = out.u0
        x_p = torch.tensor(nlp.sim_time_step(
            out.x0_updated[0].numpy(), u_p[0].numpy(), tco.TS))[None]
        assert ok_o, (i, st_o)
        assert bool(out.ok[0]), (i, int(out.status[0]))
        d = np.abs(x_o - x_p[0].numpy())
        worst = np.maximum(worst, [d[:7].max(), d[7], d[8]])
    assert worst[0] < 7.5e-4, worst
    assert worst[1] < 2.5e-4, worst
    assert worst[2] < 4e-3, worst
    assert x_o[7] > 0.15 and float(x_p[0, 7]) > 0.15


@pytest.mark.slow
def test_full_track_completion_f64():
    r = gates.track_completion(DT, "cpu", lanes=1, max_ticks=gates.N_SIM)
    assert r["ticks_to_finish"][0] < gates.N_SIM


@pytest.mark.slow
def test_full_track_completion_f32():
    """Float32 on the plain versions of K1-K4 (the kernel routes' CPU
    path), JAX's 3,000-tick budget."""
    gates.track_completion(torch.float32, "cpu", lanes=1, max_ticks=3000)


@pytest.mark.slow
def test_letter_track_dyros_completion():
    gates.letter_completion(DT, "cpu", lanes=1)


def test_letter_track_generator():
    """`tests/test_splines.py:143` on the port: "TPU" at 0.25 m in the Y-Z
    plane, no duplicate waypoints, the constant flipped pose, fit as a 6-D
    track of more than 1 m that stays within 2 cm of the waypoints."""
    from mpcc_manipulator_tpu_torch.runtime.track_gen import letter_track
    t = letter_track("TPU", height=0.25, n_points=200)
    x, y, z = (np.asarray(t[k]) for k in ("X", "Y", "Z"))
    assert np.all(x == 0.0)
    assert abs(np.ptp(z) - 0.25) < 5e-3
    assert np.hypot(np.diff(y), np.diff(z)).min() > 1e-9
    assert np.all(np.asarray(t["quat_X"]) == 1.0)
    rots = np.stack([np.diag([1.0, -1.0, -1.0])] * len(x))
    tr = als.gen_6d_spline(x, y, z, rots, device="cpu")
    assert float(tr.length) > 1.0
    p = als.track_position(tr, tr.length * 0.25).numpy()
    assert np.min(np.hypot(y - p[1], z - p[2])) < 0.02
