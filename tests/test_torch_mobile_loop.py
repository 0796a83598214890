"""The port's Husky+Panda structured IPM and tick against the JAX package,
float64 on the CPU.

* the structured IPM (K1's plain version) against JAX `solve_qp_ipm_s` on
  the QPs of tests/test_qp_ipm_pallas_mobile.py, both schemes, cold and
  warm (the SQP's clip [0.1, 100]): equal iteration counts and verdicts,
  steps within 1e-9;
* `mpc_step(system=HUSKY_PANDA)`, closed loop, tick for tick.

The JAX side runs its plain path of the bench configuration (structured
IPM, XLA kinematics, analytic manipulability gradient, RTI with the
warm-started interior point; the Panda test's ``JAX_CFG``), one
single-scenario call per lane; the port runs the four lanes as one batch
through its plain versions (CPU tensors) under ``SQPConfig()``.  Both
packages compute on identical parameters, track and network weights
(carried over by ``convert``) from `__graft_entry__._build_problem`'s
mobile problem: 1.2 m of forward travel, beyond the arm's reach.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import load_params as j_load_params
from mpcc_manipulator_tpu.solver import qp_ipm
from mpcc_manipulator_tpu.system import HUSKY_PANDA as JSYS
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME_MOBILE
from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import solve_qp_ipm_plain
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA as SYS
from tests.test_torch_mobile import _close, _mobile_track, _np
from tests.test_torch_mpc import JAX_CFG

torch.set_num_threads(1)

TS = 0.01
N_TICKS = 10
BATCH = 4
# float64 closed loop: the two implementations differ only in summation
# order, so states agree to roundoff amplified over the ticks
STATE_TOL = 1e-8
B = 3


@pytest.fixture(scope="module")
def mobile_qpk64():
    """The mobile QPs of tests/test_qp_ipm_pallas_mobile.py (seed 1, three
    lanes at the home state + 0.002 N(0, 1)), assembled by JAX in
    float64."""
    jp, _ = j_load_params(system=JSYS, dtype=jnp.float64)
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    jtrack, x0 = _mobile_track(jnp.float64)
    rng = np.random.default_rng(1)
    z0 = np.concatenate([np.tile(x0, 11), np.zeros(SYS.nu * 10)])
    zs = jnp.asarray(z0[None] + 0.002 * rng.standard_normal((B, SYS.n_var)))

    def build(z):
        xs = z[:SYS.nx * 11].reshape(11, SYS.nx)
        rb = j_robot_data(xs[:, :SYS.dof], jnp.asarray([3., 3., 3.]),
                          jnp.asarray(0.0), jsel, jenv, mani_grad="ad",
                          system=JSYS)
        return jqs.build_qp_stages_k(jtrack, z, rb, jp, jnp.zeros(SYS.nu),
                                     TS, False, system=JSYS)

    return _np(jax.jit(jax.vmap(build))(zs))


@pytest.mark.parametrize("scheme,start", [
    ("adaptive", "cold"), ("adaptive", "warm"),
    ("mehrotra", "cold"), ("mehrotra", "warm")])
def test_mobile_ipm_matches_xla_reference_f64(mobile_qpk64, scheme, start):
    qpk = convert.stage_qpk(mobile_qpk64, torch.float64, device="cpu")
    ws = wl = None
    if start == "warm":
        # warm rows from the cold solve, clipped as the SQP clips them
        cold = solve_qp_ipm_plain(qpk, system=SYS, scheme=scheme)
        ws = torch.clamp(cold.s_rows, 0.1, 100.0)
        wl = torch.clamp(cold.lam_rows, 0.1, 100.0)
    sol = solve_qp_ipm_plain(qpk, max_iter=25, warm_s=ws, warm_lam=wl,
                             system=SYS, scheme=scheme)
    jq = jax.vmap(lambda q: jqs.qpk_to_qps(q, system=JSYS))(
        jax.tree.map(jnp.asarray, mobile_qpk64))
    kw = {} if ws is None else dict(warm_s=jnp.asarray(ws.numpy()),
                                    warm_lam=jnp.asarray(wl.numpy()))
    ref = jax.vmap(lambda q, a: qp_ipm.solve_qp_ipm_s(
        q, max_iter=25, scheme=scheme, **a))(jq, kw)
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(sol.solved.numpy(), np.asarray(ref.solved))
    assert bool(sol.solved.all())
    for f in ("du", "dx_tilde"):
        _close(getattr(sol, f), getattr(ref, f), f, 1e-9)
    assert sol.dx_tilde.shape[-1] == SYS.nxt == 23


# ------------------------------------------------------------ the tick



@pytest.fixture(scope="module")
def problem():
    from __graft_entry__ import _build_problem
    track, params, _, sel_nn, env_nn, _, _, u0, obs = _build_problem(
        jnp.float64, small=False, system=JSYS)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    port = dict(track=convert.track(np_tree(track), device="cpu"),
                params=convert.mpcc_params(np_tree(params), device="cpu"),
                sel_nn=convert.mlp(np_tree(sel_nn), device="cpu"),
                env_nn=convert.mlp(np_tree(env_nn), device="cpu"))
    rng = np.random.default_rng(7)
    x0 = X0_HOME_MOBILE[None] + 0.01 * rng.standard_normal((BATCH, SYS.nx))
    x0[:, SYS.s_idx:] = np.abs(x0[:, SYS.s_idx:])
    return (track, params, sel_nn, env_nn, u0, obs), port, x0


def test_mobile_mpc_step_matches_jax_closed_loop(problem):
    """Per tick: ok, status and IPM iterations equal, states within 1e-8;
    the loop advances s and translates the base."""
    (track, params, sel_nn, env_nn, u0, obs), port, x0 = problem
    step = jax.jit(lambda c, x, u: jax_mpc_step(
        track, params, sel_nn, env_nn, c, x, u, obs,
        jnp.asarray(0.0, jnp.float64), ts=TS, cfg=JAX_CFG, system=JSYS))

    carries = [j_init_carry(jnp.float64, JSYS)] * BATCH
    xj = [jnp.asarray(x0[i]) for i in range(BATCH)]
    uj = [u0] * BATCH
    dt = torch.float64
    carry = init_carry(BATCH, dt, "cpu", SYS)
    x = torch.tensor(x0, dtype=dt)
    u = torch.zeros(BATCH, SYS.nu, dtype=dt)
    obs_t = torch.tensor(np.asarray(obs), dtype=dt).expand(BATCH, 3)
    rad = torch.zeros(BATCH, dtype=dt)
    for t in range(N_TICKS):
        carry, out = mpc_step(port["track"], port["params"], port["sel_nn"],
                              port["env_nn"], carry, x, u, obs_t, rad,
                              ts=TS, cfg=SQPConfig(), system=SYS)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        if t == 0:
            x_first = x.clone()
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
    # progress along the track after the first tick's projection, and the
    # base moves forward
    assert bool((x[:, SYS.s_idx] > x_first[:, SYS.s_idx] + 5e-3).all())
    assert bool((x[:, 0] > x_first[:, 0] + 5e-3).all())
