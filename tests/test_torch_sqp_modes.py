"""The port's SQP modes against the JAX package, float64 on the CPU: the
converged mode (filter line search carried across iterations), the
second-order correction and the l1-merit line search, closed loop tick for
tick; and their two stage-level helpers on the same StageQPK and IPM
solution.

The JAX side runs the plain path of the same algorithm (structured IPM,
XLA kinematics, analytic manipulability gradient, warm-started interior
point), one single-scenario call per lane; the port runs the lanes as one
batch through its default configuration, whose kernels run their plain
versions on CPU tensors.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
from mpcc_manipulator_tpu.solver import sqp as jsqp
from mpcc_manipulator_tpu.system import PANDA as JPANDA
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp import qp_data
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME
from mpcc_manipulator_tpu_torch.solver import sqp
from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import solve_qp_ipm_k

torch.set_num_threads(1)

TS = 0.01
BATCH = 3
# float64 closed loop: the two implementations differ only in summation
# order, so states agree to roundoff amplified over the ticks
STATE_TOL = 1e-8
TOL = 1e-9        # one stage-level evaluation, relative to the scale

# (port SQPConfig changes, ticks): the converged mode of the bench's
# MPCC_RTI=0 run, and its two options
MODES = {
    "filter": (dict(), 8),
    "soc": (dict(do_SOC=True), 5),
    "merit": (dict(line_search="merit"), 5),
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
    rng = np.random.default_rng(17)
    x0 = X0_HOME[None] + 0.01 * rng.standard_normal((BATCH, 9))
    x0[:, 7:] = np.abs(x0[:, 7:])
    return (track, params, sel_nn, env_nn, carry, u0, obs), port, x0


@pytest.mark.parametrize("mode", list(MODES))
def test_converged_mode_matches_jax_closed_loop(problem, mode):
    (track, params, sel_nn, env_nn, carry0, u0, obs), port, x0 = problem
    change, ticks = MODES[mode]
    jcfg = JaxSQPConfig(max_iter=20, rti=False, qp_solver="riccati_struct",
                        kin_backend="xla", mani_grad="analytic",
                        ipm_warm_start=True, ipm_max_iter=25, **change)
    cfg = SQPConfig(max_iter=20, rti=False, **change)
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
    assert bool(out.ok.all())
    # the mode really iterates: some tick took more than one SQP iteration
    assert int(torch.stack(iters).max()) > 1


@pytest.fixture(scope="module")
def stage_solution(problem):
    """A StageQPK and its IPM solution at perturbed horizons (port, CPU)."""
    (_, jparams, *_), port, x0 = problem
    rng = np.random.default_rng(5)
    dt = torch.float64
    z = torch.tensor(np.concatenate([np.tile(x0, (1, 11)),
                                     np.zeros((BATCH, 80))], axis=1)
                     + 0.003 * rng.standard_normal((BATCH, 179)), dtype=dt)
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.tensor([[3.0, 3.0, 3.0]] * BATCH, dtype=dt),
                            torch.zeros(BATCH, dtype=dt), port["sel_nn"],
                            port["env_nn"], mani_grad="analytic", kin_backend="pallas")
    cu = torch.tensor(0.02 * rng.standard_normal((BATCH, 8)), dtype=dt)
    rep = ak.build_qp_stages_k_kernel(port["track"], z, rb, port["params"],
                                      cu, TS)
    sol = solve_qp_ipm_k(rep)
    return jparams, port, z, rep, sol


def _jax_lane(rep, sol, i):
    qpk = jqs.StageQPK(**{f.name: jnp.asarray(getattr(rep, f.name)[i].numpy())
                          for f in dataclasses.fields(rep)})
    jsol = types.SimpleNamespace(dx_tilde=jnp.asarray(sol.dx_tilde[i].numpy()),
                                 du=jnp.asarray(sol.du[i].numpy()))
    return qpk, jsol


def _close(got, ref, what):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, (what, err, scale)


def test_stage_model_terms_match_jax(stage_solution):
    _, _, _, rep, sol = stage_solution
    q_dot, quad = sqp._stage_model_terms(rep, sol)
    for i in range(BATCH):
        qpk, jsol = _jax_lane(rep, sol, i)
        rq, rquad = jsqp._stage_model_terms(qpk, jsol, "riccati_pallas",
                                            JPANDA)
        _close(q_dot[i:i + 1], np.reshape(rq, 1), "q_dot")
        _close(quad[i:i + 1], np.reshape(rquad, 1), "quad")
    assert bool((quad > 0).all())


def test_soc_corrected_rep_matches_jax(stage_solution):
    jparams, port, z, rep, sol = stage_solution
    soc = sqp._soc_corrected_rep(rep, sol, z, port["track"].length,
                                 port["params"])
    for i in range(BATCH):
        qpk, jsol = _jax_lane(rep, sol, i)
        ref = jsqp._soc_corrected_rep(
            qpk, jsol, jnp.asarray(z[i].numpy()),
            jnp.asarray(float(port["track"].length)), jparams,
            "riccati_pallas", JPANDA)
        for f in dataclasses.fields(soc):
            _close(getattr(soc, f.name)[i], getattr(ref, f.name), f.name)
            assert getattr(soc, f.name).is_contiguous(), f.name
    # the correction moves the polytopic offsets
    assert float((soc.d_p - rep.d_p).abs().max()) > 0.0


def test_default_config_is_the_bench_configuration():
    """`SQPConfig()` is the JAX bench's configuration (`bench.py`), and
    the port runs it."""
    cfg = SQPConfig()
    assert (cfg.qp_assembly, cfg.rti, cfg.max_iter, cfg.qp_solver,
            cfg.kin_backend, cfg.mani_grad, cfg.ipm_warm_start,
            cfg.ipm_scheme, cfg.line_search, cfg.do_SOC) == (
        "pallas", True, 1, "riccati_pallas", "pallas", "analytic", True,
        "adaptive", "filter", False)
    sqp.check_supported(cfg)
    sqp.check_supported(dataclasses.replace(cfg, qp_assembly="xla"))
