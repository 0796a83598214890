"""The last public names of ported JAX modules, held to JAX in float64 on
the CPU at 1e-12: `config.StateIndex`, `InputIndex`, `state_offset`,
`input_offset`; `collision_nn.mlp_forward`; `kinematics.ee_velocity`,
`manipulability_and_grad_analytic`; `params.load_{model,cost,bounds,
normalization,sqp}_params`; `linalg_small.solve_psd_small`;
`robot_data.index_robot_data`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu import config as jconfig
from mpcc_manipulator_tpu import params as jparams
from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.ocp import robot_data as jrd
from mpcc_manipulator_tpu.system import HUSKY_PANDA as JHUSKY
from mpcc_manipulator_tpu.utils import linalg_small as jlin
from mpcc_manipulator_tpu_torch import config, convert, params
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.ocp import robot_data as rd
from mpcc_manipulator_tpu_torch.problem import X0_HOME
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA
from mpcc_manipulator_tpu_torch.utils import linalg_small as lin

torch.set_num_threads(1)

TOL = 1e-12


def _close(got, ref, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    assert float(np.abs(got - ref).max(initial=0.0)) <= TOL * scale, what


def test_state_and_input_index_and_offsets():
    for cls, jcls in ((config.StateIndex, jconfig.StateIndex),
                      (config.InputIndex, jconfig.InputIndex)):
        names = [n for n in vars(jcls) if not n.startswith("_")]
        assert names and all(getattr(cls, n) == getattr(jcls, n)
                             for n in names)
    assert [config.state_offset(k) for k in range(11)] == \
        [jconfig.state_offset(k) for k in range(11)]
    assert [config.input_offset(k) for k in range(10)] == \
        [jconfig.input_offset(k) for k in range(10)]


@pytest.mark.parametrize("is_nerf", [True, False])
def test_mlp_forward(is_nerf):
    rng = np.random.default_rng(1)
    for jnet, n_in in ((jcnn.load_self_collision_nn(), 7),
                       (jcnn.load_env_collision_nn(), 10)):
        net = convert.mlp(jax.tree.map(np.asarray, jnet), device="cpu")
        x = rng.standard_normal((5, n_in if is_nerf else 3 * n_in))
        ref = jax.vmap(lambda v: jcnn.mlp_forward(jnet, v, is_nerf))(
            jnp.asarray(x))
        _close(cnn.mlp_forward(net, torch.tensor(x), is_nerf), ref)
        if is_nerf:
            _close(net(torch.tensor(x)), ref)


def test_ee_velocity_and_analytic_manipulability():
    rng = np.random.default_rng(2)
    qs = X0_HOME[:7] + 0.3 * rng.standard_normal((6, 7))
    dqs = rng.standard_normal((6, 7))
    _close(kin.ee_velocity(torch.tensor(qs), torch.tensor(dqs)),
           jax.vmap(jkin.ee_velocity)(jnp.asarray(qs), jnp.asarray(dqs)))
    m, dm = kin.manipulability_and_grad_analytic(torch.tensor(qs))
    jm, jdm = jax.vmap(jkin.manipulability_and_grad_analytic)(jnp.asarray(qs))
    _close(m, jm, "m")
    _close(dm, jdm, "dm")


OVERRIDES = {"model": {"tol_envcol": 4.0, "desired_ee_velocity": 0.3},
             "cost": {"qOri": 7.0}, "bounds": {"q1l": -2.0, "dVsu": 3.0},
             "normalization": {"q3": 2.5}, "sqp": {"max_iter": 7,
                                                   "eps_prim": 0.2}}


def _same_fields(got, ref):
    for f in dataclasses.fields(got):
        _close(getattr(got, f.name), getattr(ref, f.name), f.name)


@pytest.mark.parametrize("group,mobile", [
    ("model", False), ("cost", False), ("bounds", False),
    ("normalization", False), ("sqp", False), ("bounds", True),
    ("normalization", True)],
    ids=lambda v: v if isinstance(v, str) else ("husky" if v else "panda"))
def test_group_loaders(group, mobile):
    """Each group loader against JAX's with overrides; the bounds and the
    normalization (which depend on the system) for both systems."""
    file = params.param_path(f"{group}.json")
    ov = OVERRIDES[group]
    port = getattr(params, f"load_{group}_params")
    ref = getattr(jparams, f"load_{group}_params")
    kw, jkw = {}, {}
    if mobile:
        kw, jkw = dict(system=HUSKY_PANDA), dict(system=JHUSKY)
    got = port(file, ov, torch.float64, device="cpu", **kw)
    want = ref(file, ov, jnp.float64, **jkw)
    if group == "sqp":
        _same_fields(got[0], want[0])
        for f in dataclasses.fields(got[1]):
            if f.name in ("max_iter", "line_search_max_iter", "do_SOC",
                          "use_BFGS"):
                assert getattr(got[1], f.name) == getattr(want[1], f.name)
        assert got[1].max_iter == 7
    else:
        _same_fields(got, want)


@pytest.mark.parametrize("n", [6, 7])
def test_solve_psd_small(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((4, n, n))
    a = m @ np.swapaxes(m, -1, -2) + n * np.eye(n)
    for b in (rng.standard_normal((4, n)), rng.standard_normal((4, n, 3))):
        ref = jlin.solve_psd_small(jnp.asarray(a), jnp.asarray(b), n)
        _close(lin.solve_psd_small(torch.tensor(a), torch.tensor(b), n), ref)


def test_index_robot_data():
    rng = np.random.default_rng(4)
    qs = X0_HOME[:7] + 0.2 * rng.standard_normal((11, 7))
    obs, rad = np.array([0.5, 0.0, 0.6]), 0.05
    jsel, jenv = jcnn.load_self_collision_nn(), jcnn.load_env_collision_nn()
    jrb = jrd.compute_robot_data(jnp.asarray(qs), jnp.asarray(obs), rad,
                                 jsel, jenv, mani_grad="analytic")
    to = lambda n: convert.mlp(jax.tree.map(np.asarray, n), device="cpu")
    rb = rd.compute_robot_data(
        torch.tensor(qs)[None], torch.tensor(obs)[None],
        torch.tensor([rad], dtype=torch.float64), to(jsel), to(jenv),
        mani_grad="analytic", kin_backend="xla")
    for k in (0, 3, 10):
        got, ref = rd.index_robot_data(rb, k), jrd.index_robot_data(jrb, k)
        for f in dataclasses.fields(got):
            _close(getattr(got, f.name)[0], getattr(ref, f.name), f.name)
