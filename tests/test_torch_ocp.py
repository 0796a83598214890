"""Stage-QP assembly, objective and constraint values against the JAX
package, float64 on the CPU.

Both sides start from the same iterates z, current inputs and obstacle;
the port computes its own RobotData (K4 route, plain version on the CPU)
and assembles ``StageQPK``; every block must match the JAX
``build_qp_stages_k`` to 1e-9 relative to the block's scale, and so must
``qpk_to_qps``, ``total_objective`` and ``constraint_values``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.ocp import qp_data as jqd
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import load_params as j_load_params
from mpcc_manipulator_tpu.splines import arc_length as jals
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.ocp import qp_data, qp_stages
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.problem import X0_HOME

torch.set_num_threads(1)

TS = 0.01
B = 3


def _close(got, ref, what):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= 1e-9 * scale, (what, err, scale)


@pytest.fixture(scope="module", params=["far_obstacle", "near_obstacle"])
def case(request):
    jp, _ = j_load_params(dtype=jnp.float64)
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    nt = 60
    phi = np.linspace(0, 2 * np.pi, nt)
    ee = np.array([0.307, 0.0, 0.487])
    jtrack = jals.gen_6d_spline(
        np.zeros(nt) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2], np.tile(np.diag([1., -1., -1.]),
                                            (nt, 1, 1)))
    rng = np.random.default_rng(11)
    x0 = X0_HOME.copy()
    x0[7:] = [0.05, 0.1]
    zs = (np.concatenate([np.tile(x0, 11), np.zeros(80)])[None]
          + 0.002 * rng.standard_normal((B, 179)))
    cu = 0.05 * rng.standard_normal((B, 8))
    obs = (np.array([3.0, 3.0, 3.0]) if request.param == "far_obstacle"
           else np.array([0.45, 0.05, 0.55]))
    radius = np.array([0.0, 2.0, 4.0])

    def build(z, c, r):
        xs = z[:99].reshape(11, 9)
        rb = j_robot_data(xs[:, :7], jnp.asarray(obs), r, jsel, jenv,
                          mani_grad="analytic")
        qpk = jqs.build_qp_stages_k(jtrack, z, rb, jp, c, TS, False)
        obj = jqd.total_objective(jtrack, z, rb, jp)
        cv = jqd.constraint_values(jtrack, z, rb, jp, c, TS)
        return qpk, jqs.qpk_to_qps(qpk), obj, cv

    ref = jax.jit(jax.vmap(build))(jnp.asarray(zs), jnp.asarray(cu),
                                   jnp.asarray(radius))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    track = convert.track(np_tree(jtrack), device="cpu")
    params = convert.mpcc_params(np_tree(jp), device="cpu")
    sel = convert.mlp(np_tree(jsel), device="cpu")
    env = convert.mlp(np_tree(jenv), device="cpu")
    z = torch.tensor(zs)
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.tensor(obs).expand(B, 3),
                            torch.tensor(radius), sel, env, mani_grad="analytic", kin_backend="pallas")
    port = (track, z, rb, params, torch.tensor(cu))
    return ref, port


def test_stage_qpk_blocks_match_jax(case):
    (rqpk, _, _, _), (track, z, rb, params, cu) = case
    qpk = qp_stages.build_qp_stages_k(track, z, rb, params, cu, TS)
    for f in rqpk.__dataclass_fields__:
        _close(getattr(qpk, f), getattr(rqpk, f), f)
        assert getattr(qpk, f).is_contiguous(), f


def test_qpk_to_qps_matches_jax(case):
    (_, rqps, _, _), (track, z, rb, params, cu) = case
    qps = qp_stages.qpk_to_qps(
        qp_stages.build_qp_stages_k(track, z, rb, params, cu, TS))
    for f in rqps.__dataclass_fields__:
        _close(getattr(qps, f), getattr(rqps, f), f)


def test_total_objective_matches_jax(case):
    (_, _, robj, _), (track, z, rb, params, _) = case
    _close(qp_data.total_objective(track, z, rb, params), robj, "objective")


def test_constraint_values_match_jax(case):
    (_, _, _, rcv), (track, z, rb, params, cu) = case
    got = qp_data.constraint_values(track, z, rb, params, cu, TS)
    for name, g, r in zip(("constr", "lower", "upper"), got, rcv):
        _close(g, r, name)


def test_stage_step_to_dense_and_denormalize_match_jax(case):
    _, (_, _, _, params, _) = case
    rng = np.random.default_rng(12)
    dx, du = rng.standard_normal((B, 11, 17)), rng.standard_normal((B, 10, 8))
    ref = jax.vmap(jqs.stage_step_to_dense)(jnp.asarray(dx), jnp.asarray(du))
    step = qp_stages.stage_step_to_dense(torch.tensor(dx), torch.tensor(du))
    _close(step, ref, "step")
    jp, _ = j_load_params(dtype=jnp.float64)
    _close(qp_data.denormalize_step(step, params),
           jax.vmap(lambda s: jqd.denormalize_step(s, jp))(ref), "denorm")
