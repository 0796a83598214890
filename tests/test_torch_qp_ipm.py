"""K1 (`solver/qp_ipm_kernel.py`): its plain version against the JAX
interior-point solvers, cold and warm started, in both centering schemes
(adaptive, and Mehrotra's predictor-corrector).

* float32 against the Pallas kernel `_solve_batched(interpret=True)`, under
  the JAX kernel test's contract (tests/test_qp_ipm_pallas.py): iteration
  counts within +-1, identical verdicts, |d du| and |d dx~| < 5e-4, duals
  within 0.5 on solved lanes;
* float64 against the XLA `solve_qp_ipm_s` on the repacked QP: identical
  iteration counts and verdicts, steps and iterates within 1e-9 relative.

The CUDA kernel itself is compared with this plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import load_params as j_load_params
from mpcc_manipulator_tpu.solver import qp_ipm, qp_ipm_pallas
from mpcc_manipulator_tpu.splines import arc_length as jals
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.ops import cuda_build
from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
    solve_qp_ipm_k, solve_qp_ipm_plain)
from mpcc_manipulator_tpu_torch.problem import X0_HOME

torch.set_num_threads(1)

TS = 0.01
B = 3


@pytest.fixture(scope="module")
def qpk64():
    """A batch of three StageQPK (JAX assembly, float64, numpy leaves)."""
    jp, _ = j_load_params(dtype=jnp.float64)
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    nt = 60
    phi = np.linspace(0, 2 * np.pi, nt)
    ee = np.array([0.307, 0.0, 0.487])
    track = jals.gen_6d_spline(
        np.zeros(nt) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2], np.tile(np.eye(3), (nt, 1, 1)))
    x0 = X0_HOME.copy()
    x0[7:] = [0.05, 0.1]
    rng = np.random.default_rng(0)
    zs = (np.concatenate([np.tile(x0, 11), np.zeros(80)])[None]
          + 0.002 * rng.standard_normal((B, 179)))

    def build(z):
        xs = z[:99].reshape(11, 9)
        rb = j_robot_data(xs[:, :7], jnp.asarray([3., 3., 3.]),
                          jnp.asarray(0.0), jsel, jenv, mani_grad="analytic")
        return jqs.build_qp_stages_k(track, z, rb, jp, jnp.zeros(8), TS)

    return jax.tree.map(np.asarray, jax.jit(jax.vmap(build))(
        jnp.asarray(zs)))


def _jax_tree(np_tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), np_tree)


def _check_f32_contract(sol, ref):
    assert int(np.max(np.abs(sol.iters.numpy()
                              - np.asarray(ref.iters)))) <= 1
    np.testing.assert_array_equal(sol.solved.numpy(), np.asarray(ref.solved))
    assert float(np.abs(sol.du.numpy() - np.asarray(ref.du)).max()) < 5e-4
    assert float(np.abs(sol.dx_tilde.numpy()
                        - np.asarray(ref.dx_tilde)).max()) < 5e-4
    ok = np.asarray(ref.solved)
    if ok.any():
        assert float(np.abs(sol.lam.numpy()[ok]
                            - np.asarray(ref.lam)[ok]).max()) < 0.5


# Warm-start rows are clipped to the JAX kernel test's [1e-2, 1e3], except
# against the Pallas kernel under Mehrotra, where they take the SQP's own
# [0.1, 100] (SQPConfig.ipm_warm_clip_*): at [1e-2, 1e3] the Mehrotra lanes
# sit on the stopping thresholds in float32, and JAX's own solve_qp_ipm_s and
# its Pallas kernel stop more than one iteration apart on one lane of this
# batch, so the JAX contract's +-1 does not hold between the two JAX
# functions themselves.
JAX_TEST_CLIP = (1e-2, 1e3)
SQP_CLIP = (0.1, 100.0)


def _warm_rows(qpk, dtype, scheme, clip=JAX_TEST_CLIP):
    """Warm-start rows from a cold solve, clipped off the boundary."""
    cold = solve_qp_ipm_plain(convert.stage_qpk(qpk, dtype, device="cpu"),
                              scheme=scheme)
    return (torch.clamp(cold.s_rows, *clip),
            torch.clamp(cold.lam_rows, *clip), cold)


# (scheme, start); the adaptive cases keep their ids "cold" and "warm"
CASES = [pytest.param("adaptive", "cold", id="cold"),
         pytest.param("adaptive", "warm", id="warm"),
         pytest.param("mehrotra", "cold", id="mehrotra-cold"),
         pytest.param("mehrotra", "warm", id="mehrotra-warm")]


@pytest.mark.parametrize("scheme,start", CASES)
def test_plain_matches_pallas_kernel_f32(qpk64, scheme, start):
    f32 = torch.float32
    qpk = convert.stage_qpk(qpk64, f32, device="cpu")
    ws = wl = None
    if start == "warm":
        ws, wl, _ = _warm_rows(
            qpk64, f32, scheme,
            SQP_CLIP if scheme == "mehrotra" else JAX_TEST_CLIP)
    sol = solve_qp_ipm_plain(qpk, max_iter=25, warm_s=ws, warm_lam=wl,
                             scheme=scheme)
    jw = {} if ws is None else dict(warm_s=jnp.asarray(ws.numpy()),
                                    warm_lam=jnp.asarray(wl.numpy()))
    ref = qp_ipm_pallas._solve_batched(_jax_tree(qpk64, jnp.float32),
                                       max_iter=25, interpret=True,
                                       scheme=scheme, **jw)
    _check_f32_contract(sol, ref)
    assert bool(sol.solved.all())


# a budget below the iterations these QPs need: every lane stops at it
CAP = 3


@pytest.mark.parametrize("scheme,start", CASES + [
    pytest.param("adaptive", "capped", id="capped"),
    pytest.param("mehrotra", "capped", id="mehrotra-capped")])
def test_plain_matches_xla_reference_f64(qpk64, scheme, start):
    f64 = torch.float64
    qpk = convert.stage_qpk(qpk64, f64, device="cpu")
    ws = wl = None
    if start == "warm":
        ws, wl, cold = _warm_rows(qpk64, f64, scheme)
    budget = CAP if start == "capped" else 25
    sol = solve_qp_ipm_plain(qpk, max_iter=budget, warm_s=ws, warm_lam=wl,
                             scheme=scheme)
    jq = jax.vmap(jqs.qpk_to_qps)(_jax_tree(qpk64, jnp.float64))
    if ws is None:
        ref = jax.vmap(lambda q: qp_ipm.solve_qp_ipm_s(
            q, max_iter=budget, scheme=scheme))(jq)
    else:
        ref = jax.vmap(lambda q, a, b: qp_ipm.solve_qp_ipm_s(
            q, max_iter=budget, scheme=scheme, warm_s=a, warm_lam=b))(
            jq, jnp.asarray(ws.numpy()), jnp.asarray(wl.numpy()))
    if start == "capped":
        assert sol.iters.tolist() == [CAP] * B
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(sol.solved.numpy(), np.asarray(ref.solved))
    for f in ("dx_tilde", "du", "mu", "s_rows", "lam_rows", "lam"):
        r = np.asarray(getattr(ref, f))
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(getattr(sol, f).numpy() - r).max())
        assert err <= 1e-9 * scale, (f, err)
    if start == "warm":
        # seeding from the solution beats the cold iteration count
        assert int(sol.iters.max()) < int(cold.iters.max())


def test_wrapper_takes_plain_version_on_cpu(qpk64):
    qpk = convert.stage_qpk(qpk64, torch.float64, device="cpu")
    before = cuda_build.LAUNCHES["K1"]
    got = solve_qp_ipm_k(qpk)
    ref = solve_qp_ipm_plain(qpk)
    assert torch.equal(got.du, ref.du) and torch.equal(got.iters, ref.iters)
    assert cuda_build.LAUNCHES["K1"] == before


def test_unknown_scheme_raises(qpk64):
    qpk = convert.stage_qpk(qpk64, torch.float64, device="cpu")
    with pytest.raises(ValueError, match="unknown IPM scheme"):
        solve_qp_ipm_k(qpk, scheme="predictor")


def test_group_row_layout_round_trip():
    """The kernel's (N, nc) group rows <-> the packed (N+1, nc) rows, in
    the order of the JAX wrapper (`_rows_to_groups` / `groups_to_rows`)."""
    from mpcc_manipulator_tpu_torch.solver.qp_ipm import (groups_to_rows,
                                                          rows_to_groups)
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((2, 11, 59))
    ref = qp_ipm_pallas._rows_to_groups(jnp.asarray(rows), 10, 9)
    groups = rows_to_groups(torch.tensor(rows), 9)
    assert np.array_equal(groups.numpy(), np.asarray(ref))
    back = groups_to_rows(groups, 1.0, 9).numpy()
    assert np.array_equal(back[:, 1:, :18], rows[:, 1:, :18])
    assert np.array_equal(back[:, :10, 18:], rows[:, :10, 18:])
    assert np.all(back[:, 0, :18] == 1.0) and np.all(back[:, 10, 18:] == 1.0)
