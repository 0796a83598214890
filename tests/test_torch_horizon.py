"""The horizon as a parameter: the port at N = 5 and N = 20 against the JAX
package, both systems, float64 on the CPU.

* layout sizes (n_var, n_eq, n_constr, the stage dims) equal JAX's
  `System` at N = 5, 10, 20;
* the stage QP (K2's plain version) against JAX `build_qp_stages_k`, each
  block within 1e-10 of its scale;
* the structured IPM (K1's plain version) against JAX `solve_qp_ipm_s` on
  those QPs, cold and warm (the SQP's clip [0.1, 100]): equal iteration
  counts and verdicts, steps within 1e-9.

The whole tick at these horizons is held in tests/test_torch_horizon_loop.py.

The CUDA kernels at these horizons are held against these plain versions
on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu import system as jsystem
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.solver import qp_ipm
from mpcc_manipulator_tpu_torch import convert, system
from mpcc_manipulator_tpu_torch.mpc import init_carry
from mpcc_manipulator_tpu_torch.ocp import qp_data
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
from mpcc_manipulator_tpu_torch.problem import X0_HOME, X0_HOME_MOBILE
from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import solve_qp_ipm_plain
from tests.test_torch_mobile import _close, _np

torch.set_num_threads(1)

TS = 0.01
BLOCK_TOL = 1e-10   # one float64 assembly, relative to the block's scale
STEP_TOL = 1e-9     # the IPM's steps (tests/test_torch_qp_ipm.py)
CASES = [(name, n) for name in ("panda", "husky_panda") for n in (5, 20)]
IDS = [f"{name}-N{n}" for name, n in CASES]


def _systems(name: str, n: int):
    """(the port's System, JAX's System) at horizon n."""
    return (dataclasses.replace(system.SYSTEMS[name], horizon=n),
            dataclasses.replace(jsystem.SYSTEMS[name], horizon=n))


@pytest.fixture(scope="module")
def problems():
    """Per system: the JAX problem (track, params, nets, obstacle) and the
    port's copy of it (``convert``)."""
    from __graft_entry__ import _build_problem
    out = {}
    for name in ("panda", "husky_panda"):
        track, params, _, sel, env, _, _, _, obs = _build_problem(
            jnp.float64, small=False, system=jsystem.SYSTEMS[name])
        port = (convert.track(_np(track), device="cpu"),
                convert.mpcc_params(_np(params), device="cpu"),
                convert.mlp(_np(sel), device="cpu"),
                convert.mlp(_np(env), device="cpu"))
        out[name] = (track, params, sel, env, obs), port
    return out


def _home(sy) -> np.ndarray:
    return X0_HOME_MOBILE if sy.base_dof else X0_HOME


@pytest.mark.parametrize("name", ["panda", "husky_panda"])
@pytest.mark.parametrize("n", [5, 10, 20])
def test_layout_sizes_match_jax(name, n):
    sy, jsy = _systems(name, n)
    for f in ("n_var", "n_eq", "n_constr", "nx", "nu", "nxt", "nzt",
              "nc_stage", "npc"):
        assert getattr(sy, f) == getattr(jsy, f), f
    assert sy.n_var == sy.nx * (n + 1) + sy.nu * n
    assert init_carry(1, torch.float64, "cpu", sy).ipm_s.shape == (
        1, n + 1, sy.nc_stage)


@pytest.fixture(scope="module")
def stage_cases(problems):
    """Per (system, N): three perturbed cold-start iterates, their stage QP
    assembled by JAX (numpy leaves) and the port's inputs."""
    out = {}
    for name, n in CASES:
        sy, jsy = _systems(name, n)
        (jtrack, jp, jsel, jenv, obs), (track, params, sel, env) = \
            problems[name]
        rng = np.random.default_rng(n)
        x0 = _home(sy).copy()
        x0[sy.s_idx:] = [0.05, 0.1]
        zs = (np.concatenate([np.tile(x0, n + 1), np.zeros(sy.nu * n)])[None]
              + 0.002 * rng.standard_normal((3, sy.n_var)))
        cu = 0.01 * rng.standard_normal((3, sy.nu))

        def build(z, c, jsy=jsy):
            xs = z[:jsy.nx * (n + 1)].reshape(n + 1, jsy.nx)
            rb = j_robot_data(xs[:, :jsy.dof], obs, jnp.asarray(0.0), jsel,
                              jenv, mani_grad="analytic", system=jsy)
            return jqs.build_qp_stages_k(jtrack, z, rb, jp, c, TS, False,
                                         system=jsy)

        ref = _np(jax.jit(jax.vmap(build))(jnp.asarray(zs), jnp.asarray(cu)))
        z = torch.tensor(zs)
        xs, _ = qp_data.split_z(z, sy)
        rb = compute_robot_data(
            xs[..., :sy.dof].contiguous(),
            torch.tensor(np.asarray(obs)).expand(3, 3),
            torch.zeros(3, dtype=torch.float64), sel, env,
            mani_grad="analytic", system=sy, kin_backend="pallas")
        qpk = ak.build_qp_stages_k_plain(track, z, rb, params,
                                         torch.tensor(cu), TS, system=sy)
        out[name, n] = ref, qpk
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_stage_qp_matches_jax(stage_cases, case):
    ref, qpk = stage_cases[case]
    n = case[1]
    for f in ref.__dataclass_fields__:
        _close(getattr(qpk, f), getattr(ref, f), f, BLOCK_TOL)
    assert qpk.e.shape[1] == n and qpk.hxx.shape[1] == n + 1


@pytest.fixture(scope="module")
def ipm_refs(stage_cases):
    """Per (system, N): JAX `solve_qp_ipm_s` cold, and warm from its cold
    slacks and duals clipped as the SQP clips them (one compile)."""
    out = {}
    for case in CASES:
        ref_qpk, _ = stage_cases[case]
        jsy = _systems(*case)[1]
        clip = lambda a: jnp.clip(a, 0.1, 100.0)

        def solve(q, jsy=jsy):
            qs = jqs.qpk_to_qps(q, system=jsy)
            cold = qp_ipm.solve_qp_ipm_s(qs, max_iter=25)
            warm = qp_ipm.solve_qp_ipm_s(qs, max_iter=25,
                                         warm_s=clip(cold.s_rows),
                                         warm_lam=clip(cold.lam_rows))
            return {"cold": cold, "warm": warm}

        out[case] = _np(jax.jit(jax.vmap(solve))(
            jax.tree.map(jnp.asarray, ref_qpk)))
    return out


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_structured_ipm_matches_jax(stage_cases, ipm_refs, case, start):
    _, qpk = stage_cases[case]
    sy = _systems(*case)[0]
    kw = {}
    if start == "warm":
        cold = ipm_refs[case]["cold"]
        kw = dict(warm_s=torch.clamp(torch.tensor(cold.s_rows), 0.1, 100.0),
                  warm_lam=torch.clamp(torch.tensor(cold.lam_rows), 0.1,
                                       100.0))
    sol = solve_qp_ipm_plain(qpk, max_iter=25, system=sy, **kw)
    ref = ipm_refs[case][start]
    np.testing.assert_array_equal(sol.iters.numpy(), ref.iters)
    np.testing.assert_array_equal(sol.solved.numpy(), ref.solved)
    assert bool(sol.solved.all())
    for f in ("du", "dx_tilde"):
        _close(getattr(sol, f), getattr(ref, f), f, STEP_TOL)
