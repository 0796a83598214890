"""The port's dense ADMM QP solver (`mpcc_manipulator_tpu_torch/solver/
qp_admm.py`) and K5's plain version (`ops/admm_kernel.py`) against the JAX
package's `solver/qp_admm.py` and `ops/pallas_admm.py`, on the CPU.

The plain route (``backend="xla"``) is held to JAX's in float64 on the five
problems of `tests/test_qp_admm.py`; the K5 route (``backend="pallas"``,
whose plain version runs for CPU tensors, in float32) is held to JAX's
kernel in interpret mode at `tests/test_pallas_admm.py`'s tolerances.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.config import N_CONSTR, N_VAR
from mpcc_manipulator_tpu.ops import pallas_admm as jpa
from mpcc_manipulator_tpu.solver import qp_admm as jqa
from mpcc_manipulator_tpu_torch.ops import admm_kernel
from mpcc_manipulator_tpu_torch.solver import qp_admm

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-10       # one float64 evaluation, relative to the scale
SOLVE_TOL = 1e-8  # float64 ADMM trajectories, same iteration counts


def _spd(rng, n, shift):
    h = rng.standard_normal((n, n))
    return h @ h.T + shift * np.eye(n)


def _problems():
    """The five problems of tests/test_qp_admm.py: (name, (p, q, a, l, u),
    max_iter)."""
    out = []
    rng = np.random.default_rng(0)
    n, m = 20, 8
    p = _spd(rng, n, 1.0)
    q = rng.standard_normal(n)
    a = rng.standard_normal((m, n))
    bb = rng.standard_normal(m)
    out.append(("equality", (p, q, a, bb, bb), 2000))
    rng = np.random.default_rng(1)
    n = 15
    d = rng.uniform(0.5, 3.0, n)
    q = rng.standard_normal(n) * 2
    out.append(("box", (np.diag(d), q, np.eye(n), -0.5 * np.ones(n),
                        0.5 * np.ones(n)), 2000))
    rng = np.random.default_rng(2)
    n, m = 30, 50
    p = _spd(rng, n, 0.1)
    q = rng.standard_normal(n)
    a = rng.standard_normal((m, n))
    out.append(("inequality", (p, q, a, -rng.uniform(0.1, 1.0, m),
                               rng.uniform(0.1, 1.0, m)), 4000))
    rng = np.random.default_rng(3)
    n = 25
    p = _spd(rng, n, 0.5)
    q = rng.standard_normal(n)
    a_eq, b_eq = rng.standard_normal((5, n)), rng.standard_normal(5)
    a_in, u_in = rng.standard_normal((10, n)), rng.uniform(0.5, 1.5, 10)
    out.append(("mixed_inf", (p, q, np.vstack([a_eq, a_in]),
                              np.concatenate([b_eq, -1e30 * np.ones(10)]),
                              np.concatenate([b_eq, u_in])), 4000))
    out.append(("early_exit", (np.eye(5), np.ones(5), np.eye(5),
                               -10 * np.ones(5), 10 * np.ones(5)), 1000))
    return out


PROBLEMS = _problems()


def _batch(qps, dtype=F64):
    """Stack single QPs into the port's batched tensors."""
    return tuple(torch.tensor(np.stack(v), dtype=dtype) for v in zip(*qps))


def _close(got, ref, tol, what):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("name", [p[0] for p in PROBLEMS])
def test_ruiz_and_factor_match_jax(name):
    (_, qp, _), = [p for p in PROBLEMS if p[0] == name]
    got = qp_admm._ruiz_equilibrate(*_batch([qp]))
    ref = jqa._ruiz_equilibrate(*(jnp.asarray(v) for v in qp))
    for what, g, r in zip(("p", "q", "a", "l", "u", "d", "e", "c"), got,
                          ref):
        _close(g[0].numpy(), r, TOL, what)
    p_s, _, a_s, l_s, u_s = got[:5]
    rho = torch.where((u_s - l_s).abs() < 1e-12,
                      torch.tensor(100.0, dtype=F64),
                      torch.tensor(0.1, dtype=F64))
    kinv = qp_admm._factor(p_s, a_s, rho)
    kref = jqa._factor(jnp.asarray(p_s[0].numpy()), jnp.asarray(
        a_s[0].numpy()), jnp.asarray(rho[0].numpy()))
    _close(kinv[0].numpy(), kref, TOL, "kinv")


@pytest.mark.parametrize("name", [p[0] for p in PROBLEMS])
def test_solve_qp_xla_matches_jax(name):
    """Same iterations and verdict; x and y within 1e-8, and the unscaled
    OSQP residuals of the final iterate (computed inside JAX's
    ``solve_qp``) within 1e-10."""
    (_, qp, max_iter), = [p for p in PROBLEMS if p[0] == name]
    sol = qp_admm.solve_qp(*_batch([qp]), max_iter=max_iter)
    ref = jqa.solve_qp(*(jnp.asarray(v) for v in qp), max_iter=max_iter)
    assert int(sol.iters[0]) == int(ref.iters)
    assert bool(sol.solved[0]) == bool(ref.solved)
    _close(sol.x[0].numpy(), ref.x, SOLVE_TOL, "x")
    _close(sol.y[0].numpy(), ref.y, SOLVE_TOL, "y")
    _close(sol.prim_res[:1].numpy(), np.reshape(ref.prim_res, 1), TOL,
           "prim_res")
    _close(sol.dual_res[:1].numpy(), np.reshape(ref.dual_res, 1), TOL,
           "dual_res")


def _random_qp(rng, n=40, m=70):
    """tests/test_pallas_admm.py's random QP (float32)."""
    q_half = rng.standard_normal((n, n))
    p = (q_half @ q_half.T + 0.5 * np.eye(n)).astype(np.float32)
    q = rng.standard_normal(n).astype(np.float32)
    a = rng.standard_normal((m, n)).astype(np.float32)
    l = np.concatenate([rng.standard_normal(10),
                        -1e30 * np.ones(m - 10)]).astype(np.float32)
    u = np.concatenate([l[:10], rng.uniform(0.5, 2.0, m - 10)]).astype(
        np.float32)
    return p, q, a, l, u


def _boxed_qp(rng, n, m):
    """A random QP whose rows are all two-sided, |a_i x| <= 0.5 (float32;
    chip_smoke.py's ``boxed_qps``)."""
    g = 0.1 * rng.standard_normal((n, n))
    p = (g @ g.T + np.eye(n)).astype(np.float32)
    q = rng.standard_normal(n).astype(np.float32)
    a = rng.standard_normal((m, n)).astype(np.float32)
    return p, q, a, np.full(m, -0.5, np.float32), np.full(m, 0.5, np.float32)


def _mpcc_sized_qp():
    """tests/test_pallas_admm.py's QP with the MPCC dimensions (float32)."""
    rng = np.random.default_rng(2)
    qh = rng.standard_normal((N_VAR, N_VAR)) * 0.1
    p = (qh @ qh.T + np.eye(N_VAR)).astype(np.float32)
    q = rng.standard_normal(N_VAR).astype(np.float32)
    a = np.zeros((N_CONSTR, N_VAR), dtype=np.float32)
    a[:N_VAR] = np.eye(N_VAR)
    a[N_VAR:N_VAR + 90] = rng.standard_normal((90, N_VAR)) * 0.3
    l = np.full(N_CONSTR, -1e30, dtype=np.float32)
    u = np.full(N_CONSTR, 1e30, dtype=np.float32)
    l[:N_VAR], u[:N_VAR] = -2.0, 2.0
    l[N_VAR:N_VAR + 45] = u[N_VAR:N_VAR + 45] = 0.3
    l[N_VAR + 90:] = u[N_VAR + 90:] = 0.0
    return p, q, a, l, u


def _scaled_inputs(qp):
    """K5's inputs for one QP, built by the JAX package (Ruiz, rho, K^-1),
    float32 numpy: (kinv, p, a, q, rho, l, u, dscl, escl, cscl)."""
    p_s, q_s, a_s, l_s, u_s, d, e, c = jqa._ruiz_equilibrate(
        *(jnp.asarray(v) for v in qp))
    rho = jnp.where(jnp.abs(u_s - l_s) < 1e-12, 100.0, 0.1).astype(p_s.dtype)
    kinv = jqa._factor(p_s, a_s, rho)
    return [np.asarray(v, dtype=np.float32)
            for v in (kinv, p_s, a_s, q_s, rho, l_s, u_s, d, e, c)]


# name -> (QP, x tolerance, max_iter of the solve).  Beside the JAX test's
# QPs, the shapes that stress K5's split of A over a thread block cluster:
# fewer rows than the cluster has blocks (a block owns no rows), and a
# ragged n, m that no cluster size divides.
KERNEL_CASES = {
    "random_seed0": (lambda: _random_qp(np.random.default_rng(0)), 5e-3,
                     500),
    "random_seed1": (lambda: _random_qp(np.random.default_rng(1)), 5e-3,
                     500),
    "mpcc_sized": (_mpcc_sized_qp, 1e-2, 1000),
    "tiny_n6_m3": (lambda: _boxed_qp(np.random.default_rng(5), 6, 3), 5e-3,
                   500),
    "ragged_n41_m73": (lambda: _boxed_qp(np.random.default_rng(6), 41, 73),
                       5e-3, 500),
}


def _case_qp(name):
    return KERNEL_CASES[name][0]()


def _kernel_args(ins, warm):
    """JAX and port argument lists for one scaled QP and warm iterate."""
    jargs = [jnp.asarray(v) for v in ins + warm]
    targs = ([torch.tensor(v)[None] for v in ins[:9]]
             + [torch.tensor(ins[9]).reshape(1)]
             + [torch.tensor(v)[None] for v in warm])
    return jargs, targs


def _cold(ins):
    n, m = ins[1].shape[0], ins[2].shape[0]
    return [np.zeros(n, np.float32), np.zeros(m, np.float32),
            np.zeros(m, np.float32)]


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_fused_admm_plain_matches_jax_kernel(name):
    """K5's plain version against the JAX kernel (interpret mode) on the
    same scaled QP, cold started."""
    tol = KERNEL_CASES[name][1]
    ins = _scaled_inputs(_case_qp(name))
    kw = dict(max_iter=500, check_every=25)
    jargs, targs = _kernel_args(ins, _cold(ins))
    jx, _, _, jit = jpa.fused_admm(*jargs, interpret=True, **kw)
    x, z, y, it = admm_kernel.fused_admm(*targs, **kw)
    assert x.dtype == torch.float32 and z.shape == y.shape
    assert abs(int(it[0]) - int(jit)) <= 50, (int(it[0]), int(jit))
    _close(x[0].numpy(), jx, tol, "x")


@pytest.mark.parametrize("name", ["box", "early_exit"])
def test_converged_warm_start_exits_at_entry(name):
    """A warm start that already passes the test leaves with it = 0 in the
    JAX kernel and in the plain version, unchanged."""
    (_, qp, _), = [p for p in PROBLEMS if p[0] == name]
    ins = _scaled_inputs(tuple(np.asarray(v, np.float32) for v in qp))
    kw = dict(max_iter=1000, check_every=25)
    jx, jz, jy, jit = jpa.fused_admm(*_kernel_args(ins, _cold(ins))[0],
                                     interpret=True, **kw)
    assert 0 < int(jit) < 1000
    warm = [np.asarray(v) for v in (jx, jz, jy)]
    jargs, targs = _kernel_args(ins, warm)
    _, _, _, jit0 = jpa.fused_admm(*jargs, interpret=True, **kw)
    x, _, _, it0 = admm_kernel.fused_admm(*targs, **kw)
    assert int(jit0) == 0 and int(it0[0]) == 0
    assert np.array_equal(x[0].numpy(), warm[0])


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_solve_qp_pallas_matches_jax_pallas_interpret(name):
    tol = KERNEL_CASES[name][1]
    qp = _case_qp(name)
    max_iter = KERNEL_CASES[name][2]
    ref = jqa.solve_qp(*(jnp.asarray(v) for v in qp), max_iter=max_iter,
                       backend="pallas_interpret")
    sol = qp_admm.solve_qp(*_batch([qp], torch.float32), max_iter=max_iter,
                           backend="pallas")
    assert abs(int(sol.iters[0]) - int(ref.iters)) <= 50
    _close(sol.x[0].numpy(), ref.x, tol, "x")
    assert float(sol.prim_res[0]) < 1e-3 and float(sol.dual_res[0]) < 1e-2


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batched_solve_equals_separate_calls(backend):
    """The batched form equals B separate calls lane for lane (each lane
    frozen once done): the inequality, mixed and early-exit problems of
    equal size, padded to one shape."""
    rng = np.random.default_rng(4)
    n, m = 12, 20
    qps = []
    for k in range(3):
        p = _spd(rng, n, 0.3)
        a = rng.standard_normal((m, n))
        lo = np.concatenate([-rng.uniform(0.1, 1.0, m - 4),
                             -1e30 * np.ones(4)])
        hi = rng.uniform(0.1, 1.0, m)
        if k == 2:      # an easy lane that stops early
            lo, hi = -10 * np.ones(m), 10 * np.ones(m)
        qps.append((p, rng.standard_normal(n), a, lo, hi))
    dtype = F64 if backend == "xla" else torch.float32
    both = qp_admm.solve_qp(*_batch(qps, dtype), max_iter=600,
                            backend=backend)
    assert len(set(both.iters.tolist())) > 1
    for i, qp in enumerate(qps):
        one = qp_admm.solve_qp(*_batch([qp], dtype), max_iter=600,
                               backend=backend)
        for f in dataclasses.fields(one):
            g, r = getattr(both, f.name)[i], getattr(one, f.name)[0]
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=1e-12 if backend == "xla"
                                       else 1e-6, err_msg=f.name)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_nan_lane_stays_unconverged_and_isolated(backend):
    qps = [p[1] for p in PROBLEMS[2:3]] * 3
    dtype = F64 if backend == "xla" else torch.float32
    args = _batch(qps, dtype)
    clean = qp_admm.solve_qp(*args, max_iter=300, backend=backend)
    args[1][1, 3] = float("nan")
    dirty = qp_admm.solve_qp(*args, max_iter=300, backend=backend)
    assert not bool(dirty.solved[1]) and int(dirty.iters[1]) == 300
    assert bool(torch.isnan(dirty.x[1]).all())
    keep = torch.tensor([True, False, True])
    for f in dataclasses.fields(clean):
        assert torch.equal(getattr(dirty, f.name)[keep],
                           getattr(clean, f.name)[keep]), f.name


def test_plain_loop_refuses_cuda_tensors():
    """Every route runs on any device, the plain ADMM loop on CUDA tensors
    too (the JAX package's ``api.MPCC`` default runs it on the
    accelerator): no route refuses a device any more.  The routes are
    JAX's three (``"pallas_interpret"``: K5's plain version);
    a backend JAX does not have raises and names the ones there are."""
    assert qp_admm.BACKENDS == ("xla", "pallas", "pallas_interpret")
    for backend in qp_admm.BACKENDS:
        qp_admm.check_route(backend)
    for bad in ("pallas_gpu", "osqp"):
        with pytest.raises(ValueError, match="qp_backend"):
            qp_admm.check_route(bad)
