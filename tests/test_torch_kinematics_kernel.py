"""K4 (`ops/kinematics_kernel.py`): its plain version against the JAX
kinematics kernel and the XLA reference, and the RobotData A/B.

The CUDA kernel itself is compared with this plain version on the card by
``chip_smoke.py`` (there is no CUDA compiler on the CPU test machines);
here its launch mirror and its output allocation are checked.

Tolerances:
* float32 vs `kin_sweep(interpret=True)`: the JAX kernel test's contract
  (tests/test_pallas_kinematics.py): atol 2e-6 on p, R, jv, jw; rtol 2e-5
  on m; rtol 2e-3 / atol 2e-4 on dm;
* float64 vs the XLA reference: 1e-9 relative to the block's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.ops import pallas_kinematics as pkin
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.ops import cuda_build
from mpcc_manipulator_tpu_torch.ops.kinematics_kernel import (
    alloc_outputs, kin_sweep, kin_sweep_plain, launch_geometry)
from mpcc_manipulator_tpu_torch.problem import X0_HOME, X0_HOME_MOBILE
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA

torch.set_num_threads(1)

NAMES = ["p_ee", "r_ee", "jv", "jw", "manipul", "d_manipul"]


def _qs(b=2, k=4, seed=3):
    rng = np.random.default_rng(seed)
    return X0_HOME[:7] + 0.3 * rng.standard_normal((b, k, 7))


def test_plain_matches_pallas_kernel_f32():
    qs = _qs()
    ref = jax.vmap(lambda q: pkin.kin_sweep(q, interpret=True))(
        jnp.asarray(qs, dtype=jnp.float32))
    got = kin_sweep_plain(torch.tensor(qs, dtype=torch.float32))
    tol = [dict(atol=2e-6)] * 4 + [dict(rtol=2e-5, atol=1e-6),
                                   dict(rtol=2e-3, atol=2e-4)]
    for name, g, r, t in zip(NAMES, got, ref, tol):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **t)


def test_plain_matches_xla_reference_f64():
    qs = _qs(seed=4)

    def ref_one(q):
        p_ee, r_ee, origins, axes = jkin.fk_chain(q)
        jv = jnp.cross(axes, p_ee[None, :] - origins).T
        m, d = jkin.manipulability_and_grad_from_frames(p_ee, origins, axes)
        return p_ee, r_ee, jv, axes.T, m, d

    ref = jax.vmap(jax.vmap(ref_one))(jnp.asarray(qs))
    got = kin_sweep_plain(torch.tensor(qs, dtype=torch.float64))
    for name, g, r in zip(NAMES, got, ref):
        r = np.asarray(r)
        scale = max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g.numpy() - r).max()) <= 1e-9 * scale, name


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    qs = torch.tensor(_qs(seed=5), dtype=torch.float64)
    before = cuda_build.LAUNCHES["K4"]
    for g, r in zip(kin_sweep(qs), kin_sweep_plain(qs)):
        assert torch.equal(g, r)
    assert cuda_build.LAUNCHES["K4"] == before


@pytest.mark.parametrize("obs", [[3.0, 3.0, 3.0], [0.45, 0.05, 0.55]],
                         ids=["far_obstacle", "near_obstacle"])
def test_robot_data_matches_jax(obs):
    """Full RobotData (K4 route + collision NNs) against the JAX XLA path
    with the analytic manipulability gradient, float64."""
    qs = _qs(b=3, k=5, seed=6)
    radius = np.array([0.0, 3.0, 5.0])
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    ref = jax.vmap(lambda q, r: j_robot_data(
        q, jnp.asarray(obs), r, jsel, jenv, mani_grad="analytic"))(
        jnp.asarray(qs), jnp.asarray(radius))
    got = compute_robot_data(
        torch.tensor(qs), torch.tensor([obs] * 3, dtype=torch.float64),
        torch.tensor(radius), cnn.load_self_collision_nn(device="cpu"),
        cnn.load_env_collision_nn(device="cpu"), mani_grad="analytic", kin_backend="pallas")
    for f in ref.__dataclass_fields__:
        r = np.asarray(getattr(ref, f), dtype=np.float64)
        g = getattr(got, f).numpy()
        if f == "obs_radius":
            r = np.broadcast_to(r[:, None], g.shape)
        assert g.shape == r.shape, f
        scale = max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g - r).max()) <= 1e-9 * scale, f


# ---- the CUDA kernel's launch and output layout, checked on the CPU (the
# kernel itself runs only on the card)

SYSTEMS = [PANDA, HUSKY_PANDA]


@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_launch_geometry_whole_configurations_within_budget(system):
    """Each block holds whole configurations (one a thread, whole warps),
    stays within 48 KB of static shared memory, covers every configuration
    exactly, and the Panda's batch 1024 (11 knots) launches at least one
    block per SM of an H100 (132) for either system."""
    for batch in (1024, 4096):
        n = batch * 11
        g = launch_geometry(system, n)
        assert g["threads"] % 32 == 0
        assert g["configs_per_block"] == g["threads"]
        assert g["shared_bytes"] <= 48 * 1024
        assert (g["blocks"] - 1) * g["configs_per_block"] < n \
            <= g["blocks"] * g["configs_per_block"]
    assert launch_geometry(system, 1024 * 11)["blocks"] >= 132


@pytest.mark.parametrize("batch", [3, 1024])
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_alloc_outputs_views(system, batch):
    """One allocation, six contiguous, disjoint float32 views with K4's
    shapes, each starting on a 16-byte boundary."""
    k, dof = 11, system.dof
    outs = alloc_outputs(batch, k, dof, "cpu")
    shapes = [(batch, k, 3), (batch, k, 3, 3), (batch, k, 3, dof),
              (batch, k, 3, dof), (batch, k), (batch, k, dof)]
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in outs)
    base = outs[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in outs)
    spans = sorted((t.storage_offset(), t.storage_offset() + t.numel())
                   for t in outs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(t.storage_offset() % 4 == 0 for t in outs)
    for i, t in enumerate(outs):            # writing one leaves the others
        t.fill_(float(i))
    assert all(bool((t == float(i)).all()) for i, t in enumerate(outs))


@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_wrapper_is_plain_version_on_cpu_f32(system):
    """kin_sweep on a CPU float32 (B, K, dof) tensor is kin_sweep_plain,
    bit for bit, at both systems' dims."""
    rng = np.random.default_rng(7)
    home = X0_HOME_MOBILE if system.base_dof else X0_HOME
    qs = torch.tensor(home[:system.dof]
                      + 0.3 * rng.standard_normal((4, 11, system.dof)),
                      dtype=torch.float32)
    before = cuda_build.LAUNCHES["K4"]
    for g, r in zip(kin_sweep(qs, system), kin_sweep_plain(qs, system)):
        assert g.dtype == torch.float32 and torch.equal(g, r)
    assert cuda_build.LAUNCHES["K4"] == before


@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_nan_configuration_gives_nan_m_and_dm(system):
    """The NaN contract K4 is held to on the card: a NaN in one
    configuration's arm joint 3 gives NaN in its m and in the arm columns
    of its dm, from the plain version as from the JAX kernel
    (`kin_sweep(interpret=True)`, whose `jnp.clip` keeps the NaN in
    sqrt(max(det, 0))); the other configurations stay finite."""
    from mpcc_manipulator_tpu.system import HUSKY_PANDA as JSYS
    from mpcc_manipulator_tpu.system import PANDA as JPANDA
    jsys = JSYS if system.base_dof else JPANDA
    rng = np.random.default_rng(11)
    home = X0_HOME_MOBILE if system.base_dof else X0_HOME
    qs = (home[:system.dof]
          + 0.3 * rng.standard_normal((2, 4, system.dof))).astype(np.float32)
    qs[0, 1, system.base_dof + 3] = np.nan
    ref = jax.vmap(lambda q: pkin.kin_sweep(q, system=jsys, interpret=True))(
        jnp.asarray(qs))
    got = kin_sweep_plain(torch.tensor(qs), system)
    bad = np.zeros((2, 4), dtype=bool)
    bad[0, 1] = True
    for m, dm in ((np.asarray(ref[4]), np.asarray(ref[5])),
                  (got[4].numpy(), got[5].numpy())):
        assert np.isnan(m[bad]).all()
        assert np.isnan(dm[bad][:, system.base_dof:]).all()
        assert np.isfinite(m[~bad]).all() and np.isfinite(dm[~bad]).all()
