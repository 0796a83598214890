"""Port modules against their JAX counterparts, float64 on the CPU:
parameters, SO(3), splines and projection, kinematics, dynamics, collision
networks and the weight converter.

Tolerance: 1e-9 relative to each block's scale (both sides compute the
same float64 math; only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu import params as jparams
from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.runtime.track_gen import lissajous_track as j_liss
from mpcc_manipulator_tpu.splines import arc_length as jals
from mpcc_manipulator_tpu.utils import so3 as jso3
from mpcc_manipulator_tpu_torch import convert, params
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import dynamics as dyn
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.problem import X0_HOME, lissajous_track
from mpcc_manipulator_tpu_torch.splines import arc_length as als
from mpcc_manipulator_tpu_torch.utils import so3

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-9


def assert_close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


# ---------------------------------------------------------------- params


@pytest.mark.parametrize("overrides", [None, {
    "param": {"desired_ee_velocity": 0.25}, "cost": {"qC": 300.0},
    "bounds": {"q4u": -0.1}, "normalization": {"s": 3.0},
    "sqp": {"line_search_tau": 0.4, "max_iter": 7}}],
    ids=["defaults", "overrides"])
def test_load_params_matches_jax(overrides):
    jp, jcfg = jparams.load_params(overrides=overrides, dtype=jnp.float64)
    pp, pcfg = params.load_params(overrides=overrides, dtype=F64,
                                  device="cpu")
    for group in ("model", "cost", "bounds", "normalization", "sqp"):
        jg, pg = getattr(jp, group), getattr(pp, group)
        for f in jg.__dataclass_fields__:
            assert_close(getattr(pg, f), getattr(jg, f), 0.0, f"{group}.{f}")
    for f in ("max_iter", "line_search_max_iter", "do_SOC", "use_BFGS"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f


def test_sqp_config_keeps_jax_field_names():
    import dataclasses
    assert ({f.name for f in dataclasses.fields(params.SQPConfig)}
            == {f.name for f in dataclasses.fields(jparams.SQPConfig)})


# ---------------------------------------------------------------- SO(3)


def _rotations(seed=0, n=16):
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    # generic angles, plus the near-identity and near-pi branches
    angles = np.concatenate([rng.uniform(0.1, 3.0, n - 4),
                             [1e-8, 2e-7, np.pi - 2e-5, np.pi]])
    return axes * angles[:, None]


def test_so3_log_exp_match_jax():
    omegas = _rotations()
    rots = np.stack([np.asarray(jso3.exp_rot(jnp.asarray(w))) for w in omegas])
    assert_close(so3.exp_rot(t64(omegas)), rots, what="exp")
    jlog = np.stack([np.asarray(jso3.log_rot(jnp.asarray(r))) for r in rots])
    assert_close(so3.log_rot(t64(rots)), jlog, what="log")


@pytest.mark.parametrize("exact", [False, True], ids=["ref", "exact"])
def test_so3_right_jacobian_inverse_matches_jax(exact):
    phis = np.concatenate([_rotations(1, 10), np.zeros((1, 3))])
    jf = jso3.right_jacobian_inverse if exact else \
        jso3.right_jacobian_inverse_ref
    pf = so3.right_jacobian_inverse if exact else \
        so3.right_jacobian_inverse_ref
    ref = np.stack([np.asarray(jf(jnp.asarray(p))) for p in phis])
    assert_close(pf(t64(phis)), ref, what="jr_inv")


def test_linalg_small_matches_jax():
    from mpcc_manipulator_tpu.utils import linalg_small as jls
    from mpcc_manipulator_tpu_torch.utils import linalg_small as ls
    rng = np.random.default_rng(2)
    m = rng.standard_normal((4, 8, 8))
    a = m @ np.swapaxes(m, -1, -2) + 8 * np.eye(8)
    b = rng.standard_normal((4, 8, 5))
    jl = jls.cholesky_small(jnp.asarray(a), 8)
    assert_close(ls.cholesky_small(t64(a), 8), jl, what="chol")
    assert_close(ls.cho_solve_small(ls.cholesky_small(t64(a), 8), t64(b), 8),
                 jls.cho_solve_small(jl, jnp.asarray(b), 8), what="solve")


# ---------------------------------------------------------------- splines


@pytest.fixture(scope="module")
def tracks():
    tj = lissajous_track()
    assert tj == j_liss()
    ee = X0_HOME[:3] + np.array([0.3, 0.0, 0.5])
    x, y, z = als.shift_track_to(np.asarray(tj["X"]), np.asarray(tj["Y"]),
                                 np.asarray(tj["Z"]), ee)
    rng = np.random.default_rng(3)
    w = 0.2 * rng.standard_normal((len(x), 3)).cumsum(0) / len(x)
    rots = np.stack([np.asarray(jso3.exp_rot(jnp.asarray(v))) for v in w])
    return (jals.gen_6d_spline(x, y, z, rots, dtype=jnp.float64),
            als.gen_6d_spline(x, y, z, rots, dtype=F64, device="cpu"))


def test_spline_fit_matches_jax(tracks):
    jt, pt = tracks
    conv = convert.track(jax.tree.map(np.asarray, jt), device="cpu")
    for name in ("sx", "sy", "sz"):
        for f in ("delta", "length", "a", "b", "c", "d"):
            assert_close(getattr(getattr(pt, name), f),
                         getattr(getattr(jt, name), f), 0.0, f"{name}.{f}")
    for f in ("r", "omega", "c", "d"):
        assert_close(getattr(pt.sr, f), getattr(jt.sr, f), 0.0, f"sr.{f}")
        assert_close(getattr(conv.sr, f), getattr(jt.sr, f), 0.0, f"conv {f}")
    assert_close(pt.wp, jt.wp, 0.0, "wp")


@pytest.mark.parametrize("fn", ["track_position", "track_derivative",
                                "track_second_derivative",
                                "track_orientation",
                                "track_orientation_derivative"])
def test_spline_evaluation_matches_jax(tracks, fn):
    jt, pt = tracks
    length = float(jt.length)
    s = np.concatenate([np.linspace(-0.1, length + 0.1, 37), [0.0, length]])
    ref = np.stack([np.asarray(getattr(jals, fn)(jt, jnp.asarray(v)))
                    for v in s])
    assert_close(getattr(als, fn)(pt, t64(s)), ref, what=fn)


def test_project_on_spline_matches_jax(tracks):
    jt, pt = tracks
    length = float(jt.length)
    rng = np.random.default_rng(4)
    s_guess = np.concatenate([rng.uniform(0, length, 8), [length, 0.0]])
    # near the track, far from it (fallback branch), and past the end
    ee = np.stack([np.asarray(jals.track_position(jt, jnp.asarray(s)))
                   for s in s_guess])
    ee = ee + np.concatenate([0.005 * rng.standard_normal((4, 3)),
                              0.2 * rng.standard_normal((4, 3)),
                              np.zeros((2, 3))])
    ref = np.asarray([jals.project_on_spline(jt, jnp.asarray(s),
                                             jnp.asarray(e), 0.03)
                      for s, e in zip(s_guess, ee)])
    got = als.project_on_spline(pt, t64(s_guess), t64(ee),
                                torch.tensor(0.03, dtype=F64))
    assert_close(got, ref, what="projection")


# ---------------------------------------------------------------- models


def _qs(n=12, seed=5, spread=0.3):
    rng = np.random.default_rng(seed)
    return X0_HOME[:7] + spread * rng.standard_normal((n, 7))


def test_fk_and_jacobian_match_jax():
    qs = _qs()
    ref = [jax.vmap(jkin.fk_chain)(jnp.asarray(qs))[i] for i in range(4)]
    got = kin.fk_chain(t64(qs))
    for name, g, r in zip(("p_ee", "r_ee", "origins", "axes"), got, ref):
        assert_close(g, r, what=name)
    assert_close(kin.ee_jacobian(t64(qs)),
                 jax.vmap(jkin.ee_jacobian)(jnp.asarray(qs)), what="jac")


def test_manipulability_and_grad_match_jax():
    qs = _qs(seed=6)

    def ref_one(q):
        p, _, o, a = jkin.fk_chain(q)
        return jkin.manipulability_and_grad_from_frames(p, o, a)

    rm, rdm = jax.vmap(ref_one)(jnp.asarray(qs))
    p, _, o, a = kin.fk_chain(t64(qs))
    m, dm = kin.manipulability_and_grad_from_frames(p, o, a)
    assert_close(m, rm, what="m")
    assert_close(dm, rdm, what="dm")
    p, _, o, a = kin.fk_chain(t64(qs))
    jp, _, jo, ja = jax.vmap(jkin.fk_chain)(jnp.asarray(qs))
    assert_close(kin.jacobian_derivative(p, o, a),
                 jax.vmap(jkin.jacobian_derivative)(jp, jo, ja), what="dJ")


def test_kinematics_constants_are_the_jax_tables():
    c = kin.kinematics_constants()
    assert c.shape == (96,)
    assert np.array_equal(c[:63], jkin._R_OFF.reshape(-1))
    assert np.array_equal(c[63:84], jkin._P_OFF.reshape(-1))
    assert np.array_equal(c[84:93], jkin._R_POST.reshape(-1))
    assert np.array_equal(c[93:], jkin._P_POST.reshape(-1))


def test_dynamics_match_jax():
    for a, b in zip(dyn.discrete_ab(0.01), jdyn.discrete_ab(0.01)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(7)
    x, u = rng.standard_normal((5, 9)), rng.standard_normal((5, 8))
    ref_rk4 = jax.vmap(lambda a, b: jdyn.rk4_step(a, b, 0.01))(
        jnp.asarray(x), jnp.asarray(u))
    assert_close(dyn.rk4_step(t64(x), t64(u), 0.01), ref_rk4, what="rk4")
    ref_sim = np.stack([np.asarray(jdyn.sim_time_step(jnp.asarray(a),
                                                      jnp.asarray(b), 0.01))
                        for a, b in zip(x, u)])
    assert_close(dyn.sim_time_step(t64(x), t64(u), 0.01), ref_sim,
                 what="sim")


@pytest.mark.parametrize("kind", ["self", "env"])
def test_collision_nn_matches_jax(kind):
    jnet = (jcnn.load_self_collision_nn if kind == "self"
            else jcnn.load_env_collision_nn)(dtype=jnp.float64)
    pnet = (cnn.load_self_collision_nn if kind == "self"
            else cnn.load_env_collision_nn)(dtype=F64, device="cpu")
    rng = np.random.default_rng(8)
    n_in = 7 if kind == "self" else 10
    x = np.concatenate([_qs(6, 9), 0.3 * rng.standard_normal((6, 3))],
                       axis=1)[:, :n_in]
    ry, rj = jax.vmap(lambda v: jcnn.mlp_forward_jacobian(jnet, v))(
        jnp.asarray(x))
    gy, gj = cnn.mlp_forward_jacobian(pnet, t64(x))
    assert_close(gy, ry, what="y")
    assert_close(gj, rj, what="jac")
    assert_close(pnet(t64(x)), jax.vmap(lambda v: jcnn.mlp_forward(jnet, v))(
        jnp.asarray(x)), what="forward")


@pytest.mark.parametrize("kind", ["self", "env"])
def test_convert_mlp_gives_identical_outputs(kind):
    """JAX MLPParams -> the port's nn.Module: same weights, same outputs."""
    jnet = (jcnn.load_self_collision_nn if kind == "self"
            else jcnn.load_env_collision_nn)(dtype=jnp.float64)
    net = convert.mlp(jax.tree.map(np.asarray, jnet), device="cpu")
    ref_net = (cnn.load_self_collision_nn if kind == "self"
               else cnn.load_env_collision_nn)(dtype=F64, device="cpu")
    for lin, w, b in zip(net.layers, jnet.weights, jnet.biases):
        assert np.array_equal(lin.weight.numpy(), np.asarray(w))
        assert np.array_equal(lin.bias.numpy(), np.asarray(b))
    x = t64(_qs(5, 10)[:, :7] if kind == "self" else np.concatenate(
        [_qs(5, 10), np.full((5, 3), 0.4)], axis=1))
    y, j = cnn.mlp_forward_jacobian(net, x)
    y_ref, j_ref = cnn.mlp_forward_jacobian(ref_net, x)
    assert torch.equal(y, y_ref) and torch.equal(j, j_ref)
    ry, rj = jax.vmap(lambda v: jcnn.mlp_forward_jacobian(jnet, v))(
        jnp.asarray(x.numpy()))
    assert_close(y, ry, what="y")
    assert_close(j, rj, what="jac")


def test_convert_carry_matches_port_carry():
    """A batched JAX MPCCarry -> the port's MPCCarry: same fields, kinds
    and values (the ADMM warm start qp_x / qp_y included)."""
    from mpcc_manipulator_tpu import mpc as jmpc
    from mpcc_manipulator_tpu_torch import mpc as pmpc
    rng = np.random.default_rng(10)
    jc = jax.tree.map(lambda a: np.stack([np.asarray(a)] * 3),
                      jmpc.init_carry(jnp.float64))
    jc = jc.replace(z_guess=rng.standard_normal(jc.z_guess.shape),
                    valid_guess=np.array([True, False, True]),
                    num_guess_failed=np.array([0, 2, 4], dtype=np.int32),
                    qp_y=rng.standard_normal(jc.qp_y.shape),
                    ipm_lam=rng.uniform(0.1, 100.0, jc.ipm_lam.shape))
    got = convert.carry(jc, device="cpu")
    ref = pmpc.init_carry(3, F64, "cpu")
    for f in ("z_guess", "valid_guess", "num_guess_failed", "qp_x", "qp_y",
              "ipm_s", "ipm_lam"):
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype and g.shape == r.shape, f
        assert np.array_equal(g.numpy(), np.asarray(getattr(jc, f))), f
