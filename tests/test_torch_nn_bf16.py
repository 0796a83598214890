"""bf16 collision-NN GEMMs (``SQPConfig.nn_bf16``) in the port, held to the
JAX package (`tests/test_nn_bf16.py`), on the CPU.

* RobotData with ``nn_mm_dtype="bfloat16"`` against JAX's in float32, both
  systems: the NN outputs and Jacobians within 2e-3 of each block's scale
  (bf16's unit roundoff, 2^-9).  Both packages multiply the same bf16
  operands exactly and sum in float32 in different orders; an activation
  within a last-bit difference of a bf16 rounding boundary then rounds to
  the neighbouring bf16 value in the next layer, which is a bf16 roundoff
  of that activation.  In float32 without bf16 the same comparison holds
  to 1e-6;
* JAX's drift bounds, bf16 against the pipeline-dtype GEMMs: distance
  values within 0.7 cm (self) and 1.5 cm (env), Jacobians finite and
  within 10x the float32 ones' scale; the 30-tick closed loop (no active
  obstacle) within 2e-4 rad in q, in JAX's A/B configuration in a float64
  pipeline (held to JAX's bf16 run tick for tick within 1e-7) and under
  the bench's RTI in float32; on starts where the bf16 GEMMs move the
  IPM's stop test to another Newton iteration, JAX and the port both pass
  that bound (up to 4.1e-4, inside the RTI envelope 7.5e-4) and agree
  with each other; with an active obstacle (the static gate,
  `gates.static_obstacle`) the margin, the CBF rate contract and the
  self-collision margin held;
* `mpc_step` with ``nn_bf16=True`` on both systems (the bench
  configuration, float32): every lane ok, within 2e-4 of float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.system import HUSKY_PANDA as JHUSKY
from mpcc_manipulator_tpu.system import PANDA as JPANDA
from mpcc_manipulator_tpu_torch import convert, gates
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME, X0_HOME_MOBILE
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA

torch.set_num_threads(1)

DT = torch.float32
BF16_TOL = 2.0 ** -9     # relative to the block's scale
F32_TOL = 1e-6
NN_FIELDS = ("sel_dist", "d_sel_dist", "env_dist", "d_env_dist")
SYSTEMS = {"panda": (JPANDA, PANDA, X0_HOME),
           "husky_panda": (JHUSKY, HUSKY_PANDA, X0_HOME_MOBILE)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float32)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float32)
    return (jsel, jenv, convert.mlp(_np(jsel), DT, "cpu"),
            convert.mlp(_np(jenv), DT, "cpu"))


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_bf16_robot_data_matches_jax(nets, system):
    jsel, jenv, sel, env = nets
    jsys, sys_, x_home = SYSTEMS[system]
    rng = np.random.default_rng(0)
    b = 64
    qs = (x_home[:sys_.dof][None, None]
          + 0.3 * rng.standard_normal((b, 11, sys_.dof))).astype(np.float32)
    obs = (np.array([0.4, 0.0, 0.4])
           + 0.2 * rng.standard_normal((b, 3))).astype(np.float32)
    grad = "ad" if sys_.base_dof == 0 else "analytic"
    got = {}
    for mm, tol in ((None, F32_TOL), ("bfloat16", BF16_TOL)):
        ref = jax.jit(jax.vmap(lambda q, o: j_robot_data(
            q, o, jnp.float32(0.03), jsel, jenv, mani_grad="ad",
            system=jsys, nn_mm_dtype=mm)))(jnp.asarray(qs), jnp.asarray(obs))
        rb = compute_robot_data(torch.tensor(qs), torch.tensor(obs),
                                torch.full((b,), 0.03), sel, env,
                                mani_grad=grad, system=sys_,
                                kin_backend="xla",
                                nn_mm_dtype=mm)
        for f in NN_FIELDS:
            r = np.asarray(getattr(ref, f))
            g = getattr(rb, f).numpy()
            assert g.dtype == np.float32 and g.shape == r.shape, f
            err = float(np.abs(g - r).max())
            assert err <= tol * float(np.abs(r).max()), (mm, f, err)
        got[mm] = rb
    # the option is live: bf16 moves every NN output
    for f in NN_FIELDS:
        assert not torch.equal(getattr(got[None], f),
                               getattr(got["bfloat16"], f)), f


def test_bf16_forward_value_drift_bounded(nets):
    """JAX's bounds: distance values within 0.7 / 1.5 cm of float32, the
    Jacobians finite and the same order."""
    _, _, sel, env = nets
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.uniform(-1.5, 1.5, (256, 7)), dtype=DT)
    ob = torch.tensor(rng.uniform(-0.5, 0.5, (256, 3))
                      + np.array([0.4, 0.0, 0.4]), dtype=DT)
    s32 = cnn.mlp_forward_jacobian(sel, q)
    s16 = cnn.mlp_forward_jacobian(sel, q, "bfloat16")
    assert float((s32[0] - s16[0]).abs().max()) < 0.7       # cm
    ein = torch.cat([q, ob], dim=1)
    e32 = cnn.mlp_forward_jacobian(env, ein)
    e16 = cnn.mlp_forward_jacobian(env, ein, "bfloat16")
    assert float((e32[0] - e16[0]).abs().max()) < 1.5       # cm
    assert bool(torch.isfinite(e16[1]).all())
    assert float(e16[1].abs().max()) < 10.0 * float(e32[1].abs().max())
    with pytest.raises(ValueError, match="mm_dtype"):
        cnn.mlp_forward_jacobian(sel, q, "float16")


# JAX's A/B configuration: `SQPConfig(max_iter=10, qp_solver="riccati",
# ipm_max_iter=20)` over JAX's defaults (the converged mode, the plain
# kinematics with the fd gradient, a cold interior point); and the bench's
# RTI on the packed route
JAX_AB = SQPConfig(max_iter=10, rti=False, qp_solver="riccati",
                   ipm_max_iter=20, qp_assembly="xla", kin_backend="xla",
                   mani_grad="fd", ipm_warm_start=False)
RTI = SQPConfig(qp_solver="riccati", qp_assembly="xla")


def _ab_loop(dtype, cfg, ticks=30):
    """``ticks`` closed-loop ticks from JAX's `_build_problem` start (no
    active obstacle) with float32 and bf16 NN GEMMs: the two runs' states
    (T, nx); every tick ok."""
    from __graft_entry__ import _build_problem
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    track, params, _, sel_nn, env_nn, _, x0, _, obs = _build_problem(
        jdt, small=False)
    port = dict(track=convert.track(_np(track), dtype, "cpu"),
                params=convert.mpcc_params(_np(params), dtype, "cpu"),
                sel_nn=convert.mlp(_np(sel_nn), dtype, "cpu"),
                env_nn=convert.mlp(_np(env_nn), dtype, "cpu"))
    obs_t = torch.tensor(np.asarray(obs), dtype=dtype)[None]
    rad = torch.zeros(1, dtype=dtype)
    states = {}
    for bf16 in (False, True):
        run = dataclasses.replace(cfg, nn_bf16=bf16)
        carry = init_carry(1, dtype, "cpu")
        x = torch.tensor(np.asarray(x0), dtype=dtype)[None]
        u = torch.zeros(1, 8, dtype=dtype)
        xs = []
        for t in range(ticks):
            carry, out = mpc_step(port["track"], port["params"],
                                  port["sel_nn"], port["env_nn"], carry, x,
                                  u, obs_t, rad, ts=0.01, cfg=run)
            assert bool(out.ok.all()), (bf16, t)
            u = out.u0
            x = sim_time_step(out.x0_updated, u, 0.01)
            xs.append(x[0])
        states[bf16] = torch.stack(xs)
    return states[False], states[True], (track, params, sel_nn, env_nn,
                                         x0, obs)


@pytest.mark.parametrize("dtype,mode", [(torch.float64, "jax_ab"),
                                        (torch.float32, "rti")],
                         ids=["float64-jax_ab", "float32-rti"])
def test_bf16_closed_loop_drift_below_conformance_bound(dtype, mode):
    """JAX's bound: q within 2e-4 of the run without bf16 over 30 ticks.
    JAX's A/B configuration runs in a float64 pipeline, where the drift is
    the bf16 GEMMs' alone (below 1e-5), and its bf16 run is held tick for
    tick to JAX's; the float32 pipeline runs the bench's RTI.  (In float32
    the converged A/B decides filter steps on rounding-level violations,
    ROADMAP section 3, so the two packages' float32 runs part there with
    or without bf16.)"""
    f32, bf16, (track, params, sel_nn, env_nn, x0, obs) = _ab_loop(
        dtype, JAX_AB if mode == "jax_ab" else RTI)
    d = (f32 - bf16).abs()
    assert float(d[:, :7].max()) < 2e-4, float(d[:, :7].max())
    assert float(d.max()) > 0.0
    if mode != "jax_ab":
        return
    # in float64 the drift is the bf16 GEMMs' own, far inside the bound
    assert float(d[:, :7].max()) < 1e-5, float(d[:, :7].max())
    from mpcc_manipulator_tpu.models import dynamics as jdyn
    from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
    from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
    from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
    jcfg = JaxSQPConfig(max_iter=10, qp_solver="riccati", ipm_max_iter=20,
                        nn_bf16=True)
    step = jax.jit(lambda c, x, u: jax_mpc_step(
        track, params, sel_nn, env_nn, c, x, u, obs,
        jnp.asarray(0.0, jnp.float64), ts=0.01, cfg=jcfg))
    carry, x, u = j_init_carry(jnp.float64), x0, jnp.zeros(8)
    gaps = []
    for t in range(len(bf16)):
        carry, out = step(carry, x, u)
        u = out.u0
        x = jdyn.sim_time_step(out.x0_updated, u, 0.01)
        gaps.append(float(np.abs(bf16[t].numpy() - np.asarray(x)).max()))
    # a bf16 rounding of one activation that the two packages' last-bit
    # differences flip moves the states by ~1e-9, which grows over the
    # ticks (measured: 4.5e-8 after 30, against a bf16 drift of 2.2e-6)
    assert max(gaps) < 1e-7, gaps


# chip_smoke.py's bf16 start states are home + 0.01 N(0, 1) (seed 0, 1024
# draws); on these rows the bf16 GEMMs move the first tick's QP enough that
# the IPM's stop test (mu < 1e-5) falls on another Newton iteration on
# lanes 443, 488, 676 and 930 (in JAX too), and two lanes where it does not
SPLIT_LANES = (0, 1, 443, 488, 676, 930)
SPLIT = (False, False, True, True, True, True)
ENVELOPE_Q = 7.5e-4   # the repo's RTI closed-loop envelope (test_rti.py)


def test_bf16_drift_past_the_bound_only_where_newton_counts_split():
    """The bench's RTI route, float32, 10 ticks, JAX and the port on the
    same six of chip_smoke.py's 1024 starts: where the bf16 GEMMs leave
    every Newton count as it was, q stays within JAX's 2e-4 of the float32
    run; where they move the stop test to another iteration, both packages
    drift alike, up to 4.1e-4 (past JAX's one-lane bound, inside the RTI
    envelope); the two packages' bf16 runs agree within 1e-6."""
    from __graft_entry__ import _build_problem
    from mpcc_manipulator_tpu.models import dynamics as jdyn
    from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
    from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
    from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
    from tests.test_torch_mpc import JAX_CFG
    track, params, _, sel_nn, env_nn, _, _, _, _ = _build_problem(
        jnp.float32, small=False)
    x0 = (X0_HOME[None] + 0.01 * np.random.default_rng(0).standard_normal(
        (1024, 9)))[list(SPLIT_LANES)]
    b = len(SPLIT_LANES)
    obs = np.array([[3.0, 3.0, 3.0]] * b)
    runs = {}
    for bf16 in (False, True):
        jcfg = dataclasses.replace(JAX_CFG, nn_bf16=bf16)
        step = jax.jit(jax.vmap(lambda c, x, u, o: jax_mpc_step(
            track, params, sel_nn, env_nn, c, x, u, o, jnp.float32(0.0),
            ts=0.01, cfg=jcfg)))
        sim = jax.jit(jax.vmap(lambda x, u: jdyn.sim_time_step(x, u, 0.01)))
        c = jax.tree.map(lambda a: jnp.stack([a] * b),
                         j_init_carry(jnp.float32))
        x, u = jnp.asarray(x0, jnp.float32), jnp.zeros((b, 8), jnp.float32)
        xs, its = [], []
        for _ in range(10):
            c, out = step(c, x, u, jnp.asarray(obs, jnp.float32))
            assert bool(np.asarray(out.ok).all())
            u, x = out.u0, sim(out.x0_updated, out.u0)
            xs.append(np.asarray(x))
            its.append(np.asarray(out.qp_iters))
        runs["jax", bf16] = np.stack(xs), np.stack(its)
    port = dict(track=convert.track(_np(track), DT, "cpu"),
                params=convert.mpcc_params(_np(params), DT, "cpu"),
                sel_nn=convert.mlp(_np(sel_nn), DT, "cpu"),
                env_nn=convert.mlp(_np(env_nn), DT, "cpu"))
    for bf16 in (False, True):
        carry = init_carry(b, DT, "cpu")
        x, u = torch.tensor(x0, dtype=DT), torch.zeros(b, 8, dtype=DT)
        xs, its = [], []
        for _ in range(10):
            carry, out = mpc_step(port["track"], port["params"],
                                  port["sel_nn"], port["env_nn"], carry, x,
                                  u, torch.tensor(obs, dtype=DT),
                                  torch.zeros(b, dtype=DT), ts=0.01,
                                  cfg=SQPConfig(nn_bf16=bf16))
            assert bool(out.ok.all())
            u = out.u0
            x = sim_time_step(out.x0_updated, u, 0.01)
            xs.append(x.numpy())
            its.append(out.qp_iters.numpy())
        runs["port", bf16] = np.stack(xs), np.stack(its)
    for pkg in ("jax", "port"):
        (s32, i32), (s16, i16) = runs[pkg, False], runs[pkg, True]
        dq = np.abs(s32 - s16)[..., :7].max(axis=(0, 2))
        split = (i32 != i16).any(axis=0)
        assert tuple(split) == SPLIT, (pkg, split)
        assert (dq[~split] < 2e-4).all(), (pkg, dq)
        assert (dq[split] < ENVELOPE_Q).all(), (pkg, dq)
        assert dq[split].max() > 2e-4, (pkg, dq)
    gap = np.abs(runs["port", True][0] - runs["jax", True][0]).max()
    assert gap < 1e-6, gap


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_bf16_tick_runs_on_both_systems(system):
    """``SQPConfig(nn_bf16=True)`` through `mpc_step` on each system's
    problem (the bench configuration, float32, 4 lanes from home + 0.01
    N(0,1), 5 RTI ticks): every lane ok, the NN outputs moved, q within
    JAX's 2e-4 of the float32 GEMMs' run."""
    from mpcc_manipulator_tpu_torch.problem import build_problem
    _, sys_, x_home = SYSTEMS[system]
    problem = build_problem(DT, "cpu", system=sys_)
    x0 = torch.tensor(x_home[None] + 0.01 * np.random.default_rng(1)
                      .standard_normal((4, sys_.nx)), dtype=DT)
    obs = torch.tensor([[3.0, 3.0, 3.0]] * 4, dtype=DT)
    rad = torch.zeros(4, dtype=DT)
    states = {}
    for bf16 in (False, True):
        carry = init_carry(4, DT, "cpu", sys_)
        x, u = x0, torch.zeros(4, sys_.nu, dtype=DT)
        for _ in range(5):
            carry, out = mpc_step(*problem, carry, x, u, obs, rad, ts=0.01,
                                  cfg=SQPConfig(nn_bf16=bf16), system=sys_)
            assert bool(out.ok.all())
            u = out.u0
            x = sim_time_step(out.x0_updated, u, 0.01)
        states[bf16] = x
    dq = (states[True] - states[False])[:, sys_.base_dof:sys_.dof].abs()
    assert 0.0 < float(dq.max()) < 2e-4, float(dq.max())


def test_bf16_obstacle_margin_still_held():
    """The static obstacle gate (300 ticks, the converged mode) driven
    with the bf16 GEMMs: the margin, the CBF rate contract and the
    self-collision margin hold every tick (the gate's own checks)."""
    cfg = dataclasses.replace(gates.CONVERGED, nn_bf16=True)
    r = gates.static_obstacle(torch.float64, "cpu", lanes=1, disabled=False,
                              cfg=cfg)
    assert r["worst_env_min_cm"] >= gates.MARGIN - gates.EPS_CM
    assert r["worst_cbf_cm"] >= -gates.CBF_EPS_CM
