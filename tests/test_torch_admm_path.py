"""The port's dense ADMM path against the JAX package, float64 on the CPU:
the dense QP assembly (``build_qp``), the damped BFGS update, the Hessian
guard, the ValueErrors of inconsistent configurations, and the closed loop
through ``mpc_step`` tick for tick (RTI, and the converged mode with BFGS,
SOC and the merit line search).

The JAX side runs its plain path (``qp_backend="xla"``, XLA kinematics,
analytic manipulability gradient), one single-scenario call per lane; the
port runs the lanes as one batch through ``qp_backend="xla"`` (the plain
ADMM loop) and its kernels' plain versions (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu.ocp import qp_data as jqd
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
from mpcc_manipulator_tpu.solver import sqp as jsqp
from mpcc_manipulator_tpu.system import HUSKY_PANDA as JHUSKY
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp import qp_data
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME
from mpcc_manipulator_tpu_torch.solver import sqp
from mpcc_manipulator_tpu_torch.system import System

torch.set_num_threads(1)

TS = 0.01
BATCH = 3
TOL = 1e-10        # one float64 evaluation, relative to the scale
# float64 closed loop: the two implementations differ only in summation
# order, so states agree to roundoff amplified over the ticks
STATE_TOL = 1e-8
ADMM = dict(qp_solver="admm", qp_backend="xla", qp_assembly="xla")
CONVERGED = dict(rti=False, max_iter=20, qp_max_iter=400)
# (SQPConfig fields, ticks): the bench's ADMM ablation under RTI, and the
# converged ADMM mode of api.MPCC with its three options
MODES = {
    "rti": (dict(rti=True, max_iter=1, qp_max_iter=200), 10),
    "converged": (CONVERGED, 5),
    "bfgs": (dict(CONVERGED, use_BFGS=True), 5),
    "soc": (dict(CONVERGED, do_SOC=True), 5),
    "merit": (dict(CONVERGED, line_search="merit"), 5),
}


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
    rng = np.random.default_rng(23)
    x0 = X0_HOME[None] + 0.01 * rng.standard_normal((BATCH, 9))
    x0[:, 7:] = np.abs(x0[:, 7:])
    return (track, params, sel_nn, env_nn, carry, u0, obs), port, x0


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _iterates(x0, seed):
    """(z, current u, obstacle, radius): perturbed horizons at x0, an
    obstacle near the arm on the last lane (the env rows' Jacobians live)."""
    rng = np.random.default_rng(seed)
    z = (np.concatenate([np.tile(x0, (1, 11)), np.zeros((BATCH, 80))], 1)
         + 0.003 * rng.standard_normal((BATCH, 179)))
    cu = 0.05 * rng.standard_normal((BATCH, 8))
    obs = np.array([[3.0, 3.0, 3.0], [3.0, 3.0, 3.0], [0.45, 0.05, 0.55]])
    return z, cu, obs, np.array([0.0, 0.0, 4.0])


def _robot_data(port, z, obs, radius):
    xs, _ = qp_data.split_z(torch.tensor(z))
    return compute_robot_data(xs[..., :7].contiguous(), torch.tensor(obs),
                              torch.tensor(radius), port["sel_nn"],
                              port["env_nn"], mani_grad="analytic", kin_backend="pallas")


def test_build_qp_matches_jax(problem):
    (track, params, sel_nn, env_nn, *_), port, x0 = problem
    z, cu, obs, radius = _iterates(x0, 29)

    def build(z, c, o, r):
        xs = z[:99].reshape(11, 9)
        rb = j_robot_data(xs[:, :7], o, r, sel_nn, env_nn,
                          mani_grad="analytic")
        return jqd.build_qp(track, z, rb, params, c, TS)

    ref = jax.jit(jax.vmap(build))(*(jnp.asarray(v)
                                     for v in (z, cu, obs, radius)))
    got = qp_data.build_qp(port["track"], torch.tensor(z),
                           _robot_data(port, z, obs, radius), port["params"],
                           torch.tensor(cu), TS)
    for name, g, r in zip(("P", "q", "A", "l", "u", "obj", "constr"), got,
                          ref):
        _close(g, r, name)
    # the polytopic rows carry live Jacobians, and P is symmetric (to the
    # roundoff of its Gauss-Newton products)
    assert float(got[2][:, 358:].abs().max()) > 0.0
    _close(got[0].transpose(-1, -2), got[0].numpy(), "P'")


def test_dense_blocks_never_overlap():
    """Scatter ones through every index grid: no entry is reached twice,
    so assigning each block into zeros equals the JAX scatter-add."""
    from mpcc_manipulator_tpu_torch.system import PANDA
    for grids, shape in ((qp_data.P_GRIDS, (PANDA.n_var, PANDA.n_var)),
                         (qp_data.A_GRIDS, (PANDA.n_constr, PANDA.n_var))):
        hits = torch.zeros(shape)
        for rows, cols in grids.values():
            hits.index_put_((torch.as_tensor(rows.copy()),
                             torch.as_tensor(cols.copy())),
                            torch.ones(rows.shape), accumulate=True)
        assert float(hits.max()) == 1.0
    # input-box rows sit on the input columns (the deliberate deviation)
    rows, cols = qp_data.A_GRIDS["box_u"]
    assert int(cols.min()) == PANDA.nx * (PANDA.horizon + 1)


def test_build_qp_other_systems_raise():
    with pytest.raises(NotImplementedError, match="Panda at N = 10"):
        qp_data.build_qp(None, torch.zeros(1, 179), None, None, None, TS,
                         system=System(name="panda", base_dof=0, horizon=5))


@pytest.mark.parametrize("case", ["damped", "undamped", "degenerate"])
def test_bfgs_update_matches_jax(case):
    rng = np.random.default_rng({"damped": 1, "undamped": 2,
                                 "degenerate": 3}[case])
    n = 12
    h = rng.standard_normal((n, n))
    hess = h @ h.T + np.eye(n)
    step = rng.standard_normal(n)
    bs = hess @ step
    delta = {"damped": -bs + 0.1 * rng.standard_normal(n),
             "undamped": 2.0 * bs + 0.1 * rng.standard_normal(n),
             "degenerate": rng.standard_normal(n)}[case]
    if case == "degenerate":
        step = np.zeros(n)       # s'Bs = s'y = 0: the update is skipped
    ref = jsqp._bfgs_update(jnp.asarray(hess), jnp.asarray(step),
                            jnp.asarray(delta))
    got = sqp._bfgs_update(torch.tensor(hess)[None], torch.tensor(step)[None],
                           torch.tensor(delta)[None])
    _close(got[0], ref, "hess")
    if case == "degenerate":
        assert np.array_equal(got[0].numpy(), hess)
    else:
        assert not np.allclose(got[0].numpy(), hess)


def test_hessian_guard_matches_jax(problem):
    """A NaN in the iterate gives NAN_HESSIAN and a non-PD Hessian
    (negative input weight) NON_PD_HESSIAN, in both packages; a clean lane
    beside them solves."""
    (track, params, sel_nn, env_nn, *_), port, x0 = problem
    z, cu, obs, radius = _iterates(x0, 31)
    z_bad = z.copy()
    z_bad[1, 2 * 9 + 7] = np.nan     # s of knot 2: the cost's Hessian
    jcfg = JaxSQPConfig(max_iter=1, rti=True, kin_backend="xla",
                        mani_grad="analytic", qp_max_iter=50, **ADMM)
    cfg = SQPConfig(max_iter=1, rti=True, qp_max_iter=50, **ADMM)
    bad_params = params.replace(cost=params.cost.replace(
        r_dq=jnp.asarray(-1.0, jnp.float64)))

    @jax.jit
    def jsolve(z0, zr, c, o, r, p):
        xs = zr[:99].reshape(11, 9)
        rb = j_robot_data(xs[:, :7], o, r, sel_nn, env_nn,
                          mani_grad="analytic")
        res = jsqp.solve_ocp(track, rb, p, jcfg, z0, c, TS)
        return res.status, res.sqp_iters

    rb = _robot_data(port, z, obs, radius)
    for p_jax, zz, want in ((params, z_bad, [0, 2, 0]),
                            (bad_params, z, [3, 3, 3])):
        p_port = convert.mpcc_params(jax.tree.map(np.asarray, p_jax),
                                     device="cpu")
        res = sqp.solve_ocp(port["track"], rb, p_port, cfg,
                            torch.tensor(zz), torch.tensor(cu), TS)
        assert res.status.tolist() == want
        for i in range(BATCH):
            st, it = jsolve(*(jnp.asarray(v[i]) for v in (zz, z, cu, obs,
                                                           radius)), p_jax)
            assert (int(res.status[i]), int(res.sqp_iters[i])) == (
                int(st), int(it)), i


@pytest.mark.parametrize("change, system, match", [
    (dict(qp_solver="riccati_pallas", use_BFGS=True), "panda", "BFGS"),
    (dict(qp_solver="riccati", qp_assembly="xla", use_BFGS=True), "panda",
     "BFGS"),
    (dict(qp_solver="riccati", qp_assembly="pallas"), "panda",
     "riccati_pallas"),
    (dict(qp_solver="admm", qp_assembly="pallas"), "panda",
     "riccati_pallas"),
    (dict(qp_solver="admm", qp_assembly="xla"), "husky_panda", "Panda-only"),
], ids=["bfgs-riccati_pallas", "bfgs-riccati", "kernel_assembly-riccati",
        "kernel_assembly-admm", "admm-husky"])
def test_inconsistent_settings_raise_as_in_jax(change, system, match):
    """The JAX package's ValueErrors (`tests/test_sqp_features.py`),
    raised by both packages for the same configuration."""
    from mpcc_manipulator_tpu.system import PANDA as JPANDA
    jsys = JPANDA if system == "panda" else JHUSKY
    psys = System(name=system, base_dof=0 if system == "panda" else 3)
    with pytest.raises(ValueError, match=match):
        jsqp.solve_ocp(None, None, None, JaxSQPConfig(**change), None, None,
                       TS, system=jsys)
    with pytest.raises(ValueError, match=match):
        sqp.check_supported(SQPConfig(**change), psys)


@pytest.mark.parametrize("mode", list(MODES))
def test_admm_closed_loop_matches_jax(problem, mode):
    (track, params, sel_nn, env_nn, carry0, u0, obs), port, x0 = problem
    change, ticks = MODES[mode]
    jcfg = JaxSQPConfig(kin_backend="xla", mani_grad="analytic",
                        **ADMM, **change)
    cfg = SQPConfig(**ADMM, **change)
    step = jax.jit(lambda c, x, u: jax_mpc_step(
        track, params, sel_nn, env_nn, c, x, u, obs,
        jnp.asarray(0.0, jnp.float64), ts=TS, cfg=jcfg))

    carries = [carry0] * BATCH
    xj = [jnp.asarray(x0[i]) for i in range(BATCH)]
    uj = [u0] * BATCH
    dt = torch.float64
    carry = init_carry(BATCH, dt, "cpu")
    x = torch.tensor(x0, dtype=dt)
    u = torch.zeros(BATCH, 8, dtype=dt)
    obs_t = torch.tensor(np.asarray(obs), dtype=dt).expand(BATCH, 3)
    rad = torch.zeros(BATCH, dtype=dt)
    iters = []
    for t in range(ticks):
        carry, out = mpc_step(port["track"], port["params"], port["sel_nn"],
                              port["env_nn"], carry, x, u, obs_t, rad,
                              ts=TS, cfg=cfg)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        for i in range(BATCH):
            carries[i], oj = step(carries[i], xj[i], uj[i])
            uj[i] = oj.u0
            xj[i] = jdyn.sim_time_step(oj.x0_updated, oj.u0, TS)
            got = [bool(out.ok[i]), int(out.status[i]),
                   int(out.sqp_iters[i]), int(out.qp_iters[i])]
            assert got == [bool(oj.ok), int(oj.status), int(oj.sqp_iters),
                           int(oj.qp_iters)], (t, i)
        iters.append(out.sqp_iters)
        x_ref = np.stack([np.asarray(v) for v in xj])
        gap = float(np.abs(x.numpy() - x_ref).max())
        assert gap < STATE_TOL, (t, gap)
        # the ADMM warm start carried to the next tick is JAX's
        for f in ("qp_x", "qp_y"):
            ref = np.stack([np.asarray(getattr(c, f)) for c in carries])
            _close(getattr(carry, f), ref, f, 1e-6)
    assert bool(out.ok.all())
    assert float(x[:, 7].min()) > float(x0[:, 7].min())
    if mode != "rti":
        assert int(torch.stack(iters).max()) > 1
