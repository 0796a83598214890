"""The JAX package's surfaces that the port gained last, held to JAX in
float64 on the CPU:

* the package root: ``__all__`` equal to JAX's, every name resolving
  (``MPCC`` lazily), the dims equal; importing it (in a fresh interpreter)
  loads no JAX module, initialises no CUDA, starts no compiler and builds
  no kernel;
* ``config``'s dims and ``System.n_ineqb`` / ``n_ineqp`` / ``n_constr``,
  both systems at N = 5, 10 and 20: exactly JAX's;
* ``kinematics_mobile.manipulability_gradient`` (the full 10-DoF
  Jacobian's) against ``jax.grad`` on 32 seeded configurations at an
  absolute 1e-9 (the base columns are rounding-level in both), and JAX's
  property that the mobile manipulability is at least the arm's at home
  (`tests/test_kinematics_mobile.py`);
* ``collision_nn.mlp_forward_jacobian(..., is_nerf=False)`` on both nets
  at 1e-10 of the Jacobian's scale; JAX's positional ``is_nerf`` is not
  taken for the port's ``mm_dtype``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpcc_manipulator_tpu as J
from mpcc_manipulator_tpu import config as jconfig
from mpcc_manipulator_tpu import system as jsystem
from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.models import kinematics_mobile as jkmob
import mpcc_manipulator_tpu_torch as M
from mpcc_manipulator_tpu_torch import config, convert, system
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kmob
from mpcc_manipulator_tpu_torch.problem import X0_HOME_MOBILE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = ("PANDA_DOF", "PANDA_NUM_LINKS", "NX", "NU", "NPC", "N", "N_VAR",
        "N_EQ", "N_INEQB", "N_INEQP", "N_CONSTR", "N_SPLINE", "INF")
ROWS = ("nx", "nu", "npc", "n_var", "n_eq", "n_ineqb", "n_ineqp",
        "n_constr", "nxt", "nzt", "nc_stage")


def test_package_root_matches_jax():
    assert M.__all__ == J.__all__
    for name in M.__all__:
        assert getattr(M, name) is not None, name
    from mpcc_manipulator_tpu_torch.api import MPCC
    assert M.MPCC is MPCC
    for name in ("N", "NX", "NU", "NPC", "PANDA_DOF", "PANDA_NUM_LINKS"):
        assert getattr(M, name) == getattr(J, name), name
    with pytest.raises(AttributeError):
        M.no_such_name


# a fresh interpreter: what importing the package root and resolving its
# names loads (the test process itself imports JAX)
IMPORT_PROBE = """
import subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a process was started: " + repr(a[:1]))
subprocess.Popen = refuse
before = set(sys.modules)
import mpcc_manipulator_tpu_torch as M
for name in M.__all__:
    getattr(M, name)
import torch
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib",
                                                   "mpcc_manipulator_tpu"))
assert not bad, bad
assert not torch.cuda.is_initialized()
build = sys.modules.get("mpcc_manipulator_tpu_torch.ops.cuda_build")
assert build is None or build.library.cache_info().currsize == 0
print("ok", len(new))
"""


def test_package_root_imports_no_jax_and_builds_nothing():
    r = subprocess.run([sys.executable, "-c", IMPORT_PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-2000:]


@pytest.mark.parametrize("horizon", [5, 10, 20])
def test_config_dims_and_system_rows(horizon):
    for name in DIMS:
        assert getattr(config, name) == getattr(jconfig, name), name
    for port, ref in ((system.PANDA, jsystem.PANDA),
                      (system.HUSKY_PANDA, jsystem.HUSKY_PANDA)):
        port = dataclasses.replace(port, horizon=horizon)
        ref = dataclasses.replace(ref, horizon=horizon)
        for row in ROWS:
            assert getattr(port, row) == getattr(ref, row), (port.name, row)
        assert port.n_constr == port.n_eq + port.n_ineqb + port.n_ineqp


def test_mobile_manipulability_gradient():
    assert kmob.NQ_MOBILE == jkmob.NQ_MOBILE == 10
    rng = np.random.default_rng(15)
    qs = X0_HOME_MOBILE[:10] + 0.4 * rng.standard_normal((32, 10))
    got = kmob.manipulability_gradient(torch.tensor(qs))
    ref = np.asarray(jax.vmap(jkmob.manipulability_gradient)(jnp.asarray(qs)))
    assert got.shape == ref.shape == (32, 10)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-9
    # one configuration without a batch axis
    one = kmob.manipulability_gradient(torch.tensor(qs[3]))
    assert float(np.abs(one.numpy() - ref[3]).max()) <= 1e-9
    # JAX's property: the base adds columns, so m10 >= m7 at home
    q_home = torch.tensor(X0_HOME_MOBILE[:10])
    m10 = float(kmob.manipulability(q_home))
    m7 = float(kin.manipulability(q_home[3:]))
    assert m10 >= m7 - 1e-12
    assert abs(m10 - float(jkmob.manipulability(jnp.asarray(q_home.numpy())))) \
        <= 1e-12


@pytest.fixture(scope="module")
def nets():
    return [(jnet, convert.mlp(jax.tree.map(np.asarray, jnet), device="cpu"),
             n_in)
            for jnet, n_in in ((jcnn.load_self_collision_nn(), 7),
                               (jcnn.load_env_collision_nn(), 10))]


def test_mlp_forward_jacobian_unencoded(nets):
    rng = np.random.default_rng(16)
    for jnet, net, n_in in nets:
        x = rng.standard_normal((6, 3 * n_in))   # the first layer's width
        ry, rj = jax.vmap(lambda v: jcnn.mlp_forward_jacobian(
            jnet, v, is_nerf=False))(jnp.asarray(x))
        y, j = cnn.mlp_forward_jacobian(net, torch.tensor(x), is_nerf=False)
        ry, rj = np.asarray(ry), np.asarray(rj)
        assert j.shape == rj.shape == (6, ry.shape[-1], 3 * n_in)
        assert float(np.abs(y.numpy() - ry).max()) <= 1e-10 * max(
            1.0, float(np.abs(ry).max()))
        assert float(np.abs(j.numpy() - rj).max()) <= 1e-10 * max(
            1.0, float(np.abs(rj).max()))
        # JAX's third positional parameter is is_nerf, the port's mm_dtype:
        # a bool there is refused, never read as "no bf16"
        for flag in (False, True):
            with pytest.raises(ValueError, match="mm_dtype"):
                cnn.mlp_forward_jacobian(net, torch.tensor(x), flag)
