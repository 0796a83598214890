"""JAX's argument order and defaults, and JAX's interpret switches, in the
port, float64 on the CPU:

* `compute_robot_data` with each package's own defaults (JAX's: the plain
  kinematics with the finite-difference gradient) on 11 knots, both
  systems, against JAX within 1e-10 of the scale (the fd route's bound in
  `tests/test_torch_surfaces.py`);
* a JAX-style positional call of each function that takes JAX's
  positional order (`compute_robot_data`, the three parameter loaders,
  `api.MPCC`, `solve_qp_ipm_s`) giving the keyword call's result;
  `load_params(dtype=None)` PyTorch's default float dtype, as JAX's is
  JAX's default, and `IsaacBridge(dtype=None)` float64, as in JAX;
* the route rule `ops/cuda_build.kernel_route` over ``{None, True, False}``
  x ``{cpu, cuda}`` (devices, no tensor on a card), and on CPU tensors
  each kernel wrapper: ``True`` its plain version (the ``None`` result,
  bit for bit), ``False`` JAX's ``ValueError``, no launch counted;
* `mpc_step` under ``SQPConfig(ipm_interpret=True)`` (K1-K4's and K6's
  plain versions, named; no launch counted) against JAX's `mpc_step` with ``ipm_interpret=True``
  (the Pallas interpreter), Panda, batch 4, 3 ticks;
* ``qp_backend="pallas_interpret"`` equal to ``"pallas"`` on the CPU, where
  both run K5's plain version.

Alone: ``python -m pytest tests/test_torch_interpret.py -q`` (~3 min, JAX's
interpret-mode tick compiling most of it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import SQPConfig as JaxSQPConfig
from mpcc_manipulator_tpu.system import SYSTEMS as JSYSTEMS
from mpcc_manipulator_tpu_torch import params as pparams
from mpcc_manipulator_tpu_torch.api import MPCC
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import _cold_start, init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp import qp_data, qp_stages
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.ops import admm_kernel
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
from mpcc_manipulator_tpu_torch.ops import collision_nn_kernel as nnk
from mpcc_manipulator_tpu_torch.ops import cuda_build
from mpcc_manipulator_tpu_torch.ops import kinematics_kernel as kk
from mpcc_manipulator_tpu_torch.ops import projection_kernel as pk
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import (X0_HOME, X0_HOME_MOBILE,
                                                build_problem)
from mpcc_manipulator_tpu_torch.solver import qp_admm, qp_ipm
from mpcc_manipulator_tpu_torch.solver import qp_ipm_kernel as qk
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA, SYSTEMS
from tests.test_torch_mpc import JAX_CFG, problem  # noqa: F401 (fixture)

torch.set_num_threads(1)

TOL = 1e-10          # one float64 evaluation, relative to the scale
STATE_TOL = 1e-8     # float64 closed loops (tests/test_torch_mpc.py)
TS = 0.01
KNOTS = 11
F64 = torch.float64


def _close(got, ref, what, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _equal(a, b):
    """Every field of two results (dataclasses or tuples) bit for bit."""
    if dataclasses.is_dataclass(a):
        return all(_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _knots(system, lanes=2):
    home = X0_HOME if system.base_dof == 0 else X0_HOME_MOBILE
    rng = np.random.default_rng(3)
    return home[:system.dof] + 0.05 * rng.standard_normal(
        (lanes, KNOTS, system.dof))


def _nets():
    return (cnn.load_self_collision_nn(device="cpu"),
            cnn.load_env_collision_nn(device="cpu"))


# ------------------------------------------------------------ F3: defaults


@pytest.mark.parametrize("name", ["panda", "husky_panda"])
def test_robot_data_defaults_match_jax(name):
    """Both packages' ``compute_robot_data`` with nothing but the data
    given: the same route (plain kinematics, fd gradient; the mobile arm's
    autodiff one), the same fields within 1e-10 of the scale."""
    sy, jsy = SYSTEMS[name], JSYSTEMS[name]
    qs = _knots(sy)
    obs = np.array([[0.5, 0.1, 0.4], [0.4, -0.2, 0.6]])
    radius = np.array([0.05, 0.0])
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    if sy.base_dof == 0:
        call = lambda q, o, r: j_robot_data(q, o, r, jsel, jenv)
        got = compute_robot_data(torch.tensor(qs), torch.tensor(obs),
                                 torch.tensor(radius), *_nets())
    else:
        # the system is the one argument past JAX's defaults
        call = lambda q, o, r: j_robot_data(q, o, r, jsel, jenv,
                                            system=jsy)
        got = compute_robot_data(torch.tensor(qs), torch.tensor(obs),
                                 torch.tensor(radius), *_nets(), system=sy)
    ref = jax.jit(jax.vmap(call))(jnp.asarray(qs), jnp.asarray(obs),
                                  jnp.asarray(radius))
    for f in ref.__dataclass_fields__:
        r = np.asarray(getattr(ref, f))
        if f == "obs_radius":
            r = np.broadcast_to(r[:, None], (2, KNOTS))
        _close(getattr(got, f), r, f)


# ------------------------------------------------------------ F3: order


def _robot_data_calls():
    qs = torch.tensor(_knots(PANDA))
    args = (qs, torch.tensor([[0.5, 0.1, 0.4]] * 2), torch.zeros(2, dtype=F64),
            *_nets())
    return [(compute_robot_data(*args, "fd"),
             compute_robot_data(*args, mani_grad="fd")),
            (compute_robot_data(*args, "analytic", PANDA, "pallas", True,
                                None),
             compute_robot_data(*args, mani_grad="analytic", system=PANDA,
                                kin_backend="pallas", kin_interpret=True,
                                nn_mm_dtype=None))]


def _loader_calls():
    d = lambda **kw: dict(device="cpu", **kw)
    return [(pparams.load_params(None, None, F64, HUSKY_PANDA, **d()),
             pparams.load_params(dtype=F64, system=HUSKY_PANDA, **d()))]


def _group_loader_calls(name):
    load = getattr(pparams, f"load_{name}_params")
    path = pparams.param_path(f"{name}.json")
    over = {"bounds": {"q1l": -2.0}, "normalization": {"thb": 3.0}}[name]
    return [(load(path, over, F64, HUSKY_PANDA, device="cpu"),
             load(path, overrides=over, dtype=F64, system=HUSKY_PANDA,
                  device="cpu"))]


def _mpcc_calls():
    pos = MPCC(None, None, torch.float32, True, device="cpu")
    kw = MPCC(dtype=torch.float32, exact_heading_jac=True, device="cpu")
    view = lambda m: (m._dtype, m._exact_heading_jac, m.device,
                      m.sel_nn.layers[0].weight)
    return [(view(pos), view(kw))]


def _ipm_calls():
    track, params, sel, env = build_problem(F64, "cpu")
    x0 = torch.tensor(X0_HOME[None] + 0.01 * np.random.default_rng(
        5).standard_normal((2, 9)))
    z = _cold_start(x0)
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.full((2, 3), 3.0, dtype=F64),
                            torch.zeros(2, dtype=F64), sel, env,
                            mani_grad="analytic", kin_backend="pallas")
    qs = qp_stages.build_qp_stages_s(track, z, rb, params,
                                     torch.zeros(2, 8, dtype=F64), TS)
    warm = torch.full((2, PANDA.horizon + 1, PANDA.nc_stage), 0.5,
                      dtype=F64)
    return [(qp_ipm.solve_qp_ipm_s(qs, 25, "mehrotra", True, warm, warm),
             qp_ipm.solve_qp_ipm_s(qs, max_iter=25, scheme="mehrotra",
                                   fixed_iters=True, warm_s=warm,
                                   warm_lam=warm))]


POSITIONAL = {
    "compute_robot_data": _robot_data_calls,
    "load_params": _loader_calls,
    "load_bounds_params": lambda: _group_loader_calls("bounds"),
    "load_normalization_params": lambda: _group_loader_calls(
        "normalization"),
    "MPCC": _mpcc_calls,
    "solve_qp_ipm_s": _ipm_calls,
}


@pytest.mark.parametrize("name", list(POSITIONAL))
def test_jax_positional_call_is_the_keyword_call(name):
    """A call with JAX's positional order (the port's own arguments, such
    as ``device``, by name) gives what the keyword call gives."""
    for pos, kw in POSITIONAL[name]():
        assert _equal(pos, kw), name


def test_loader_dtype_defaults_follow_jax():
    """``load_params()`` is PyTorch's default float dtype (JAX's is its
    default, float64 only under ``jax_enable_x64``), and
    ``IsaacBridge(dtype=None)`` runs float64, as JAX's does."""
    from mpcc_manipulator_tpu_torch.runtime.sim_bridge import (
        IsaacBridge, LoopbackSimTransport)
    saved = torch.get_default_dtype()
    try:
        for dt in (torch.float32, torch.float64):
            torch.set_default_dtype(dt)
            p, _ = pparams.load_params(device="cpu")
            assert p.cost.q_c.dtype == dt and p.bounds.x_l.dtype == dt
    finally:
        torch.set_default_dtype(saved)
    bridge = IsaacBridge(LoopbackSimTransport(X0_HOME[:7]), device="cpu")
    assert bridge.mpc._dtype == torch.float64


# ------------------------------------------------------------ the routes


CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)
ROUTES = {(None, CPU): "plain", (None, CUDA): "kernel",
          (True, CPU): "plain", (True, CUDA): "plain",
          (False, CPU): ValueError, (False, CUDA): "kernel"}


@pytest.mark.parametrize("flag,device", list(ROUTES),
                         ids=[f"{f}-{d.type}" for f, d in ROUTES])
def test_kernel_route_table(flag, device):
    """None: the kernel on CUDA, the plain version on the CPU; True: the
    plain version on both; False: the kernel, JAX's ValueError on the CPU
    (``interpret=False`` off a TPU).  No tensor is made."""
    want = ROUTES[flag, device]
    if want is ValueError:
        with pytest.raises(ValueError, match="CUDA device"):
            cuda_build.kernel_route(flag, device)
    else:
        assert cuda_build.kernel_route(flag, device) == want


@pytest.mark.parametrize("bad", ["True", 1, 0.0])
def test_kernel_route_refuses_other_values(bad):
    with pytest.raises(ValueError, match="expected one of"):
        cuda_build.kernel_route(bad, CPU)


@pytest.fixture(scope="module")
def kernel_inputs():
    """Each wrapper's arguments at a small size on CPU tensors, float64."""
    track, params, sel, env = build_problem(F64, "cpu")
    rng = np.random.default_rng(9)
    x0 = torch.tensor(X0_HOME[None] + 0.01 * rng.standard_normal((2, 9)))
    z = _cold_start(x0)
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.full((2, 3), 3.0, dtype=F64),
                            torch.zeros(2, dtype=F64), sel, env,
                            mani_grad="analytic", kin_backend="pallas")
    cu = torch.tensor(0.02 * rng.standard_normal((2, 8)))
    qpk = qp_stages.build_qp_stages_k(track, z, rb, params, cu, TS)
    n, m = 6, 4
    a = torch.tensor(rng.standard_normal((1, m, n)))
    p = torch.tensor(np.eye(n)[None] * 2.0)
    (p_s, q_s, a_s, l_s, u_s, d, e, c, rho,
     kinv) = qp_admm.equilibrated(p, torch.ones(1, n, dtype=F64), a,
                                  -torch.ones(1, m, dtype=F64),
                                  torch.ones(1, m, dtype=F64))
    f32 = lambda t: t.to(torch.float32).contiguous()
    admm = [f32(t) for t in (kinv, p_s, a_s, q_s, rho, l_s, u_s, d, e, c)]
    admm += [torch.zeros(1, n), torch.zeros(1, m), torch.zeros(1, m)]
    return {
        "K1": (qk.solve_qp_ipm_k, (qpk,), {}),
        "K2": (ak.build_qp_stages_k_kernel, (track, z, rb, params, cu, TS),
               {}),
        "K3": (ak.eval_point_kernel, (track, z + 0.01, rb, params, cu, TS),
               {}),
        "K4": (kk.kin_sweep, (xs[..., :7].contiguous(),), {}),
        "K5": (admm_kernel.fused_admm, tuple(admm), dict(max_iter=100)),
        "K6": (pk.project_and_vs, (track, x0, torch.zeros(2, 8, dtype=F64),
                                   params.model.max_dist_proj), {}),
        "K7": (nnk.forward_jacobian, (env, xs[..., :7].reshape(-1, 7), 0,
                                      torch.full((2, 3), 3.0, dtype=F64),
                                      11), dict(cols=7)),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6",
                                    "K7"])
def test_wrapper_takes_the_named_route_on_the_cpu(kernel, kernel_inputs):
    """On CPU tensors ``interpret=True`` is the plain version (what
    ``None`` runs there, bit for bit) and ``interpret=False`` raises JAX's
    ValueError; no call counts a launch."""
    fn, args, kw = kernel_inputs[kernel]
    before = fn.launches
    ref = fn(*args, **kw)
    assert _equal(fn(*args, interpret=True, **kw), ref)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args, interpret=False, **kw)
    assert fn.launches == before


# ------------------------------------------------------------ ipm_interpret


def test_ipm_interpret_tick_matches_jax_interpreter(problem):  # noqa: F811
    """``SQPConfig(ipm_interpret=True)`` against JAX's bench configuration
    with ``ipm_interpret=True``, 4 lanes x 3 ticks: JAX runs its Pallas
    kernels in the interpreter, the port K1-K4's and K6's plain versions.  Every
    tick's verdicts and Newton counts are JAX's.  JAX's kernels compute in
    float32 (they cast their inputs, `ops/pallas_kinematics.py:279`,
    `ops/pallas_assembly.py:586`) where the port's plain versions keep
    float64; so the port's states stay within 1e-8 of JAX's plain path
    (``JAX_CFG``, the bench route's bound in tests/test_torch_mpc.py), and
    its gap to JAX's interpreter is JAX's own interpreter-to-plain gap,
    within 1e-8."""
    (track, params, sel_nn, env_nn, carry0, u0, obs), port, x0 = problem
    batch, ticks = 4, 3
    jax_interp = JaxSQPConfig(
        max_iter=1, rti=True, qp_solver="riccati_pallas",
        qp_assembly="pallas", kin_backend="pallas", mani_grad="analytic",
        ipm_warm_start=True, ipm_max_iter=25, ipm_interpret=True)

    def jax_run(cfg):
        step = jax.jit(lambda c, x, u: jax_mpc_step(
            track, params, sel_nn, env_nn, c, x, u, obs,
            jnp.asarray(0.0, jnp.float64), ts=TS, cfg=cfg))
        carries, us = [carry0] * batch, [u0] * batch
        xs = [jnp.asarray(x0[i]) for i in range(batch)]
        out = []
        for _ in range(ticks):
            tick = []
            for i in range(batch):
                carries[i], o = step(carries[i], xs[i], us[i])
                us[i] = o.u0
                xs[i] = jdyn.sim_time_step(o.x0_updated, o.u0, TS)
                tick.append((bool(o.ok), int(o.status), int(o.qp_iters)))
            out.append((np.stack([np.asarray(v) for v in xs]), tick))
        return out

    ref_interp, ref_plain = jax_run(jax_interp), jax_run(JAX_CFG)
    carry = init_carry(batch, F64, "cpu")
    x = torch.tensor(x0, dtype=F64)
    u = torch.zeros(batch, 8, dtype=F64)
    obs_t = torch.tensor(np.asarray(obs), dtype=F64).expand(batch, 3)
    rad = torch.zeros(batch, dtype=F64)
    counts = {fn: fn.launches for fn in (
        qk.solve_qp_ipm_k, ak.build_qp_stages_k_kernel,
        ak.eval_point_kernel, kk.kin_sweep, pk.project_and_vs)}
    for t in range(ticks):
        carry, out = mpc_step(port["track"], port["params"], port["sel_nn"],
                              port["env_nn"], carry, x, u, obs_t, rad,
                              ts=TS, cfg=SQPConfig(ipm_interpret=True))
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        (xi, tick), (xp, _) = ref_interp[t], ref_plain[t]
        assert [(bool(out.ok[i]), int(out.status[i]), int(out.qp_iters[i]))
                for i in range(batch)] == tick, t
        plain_gap = float(np.abs(x.numpy() - xp).max())
        interp_gap = float(np.abs(x.numpy() - xi).max())
        jax_gap = float(np.abs(xi - xp).max())
        assert plain_gap < STATE_TOL, (t, plain_gap)
        assert interp_gap <= jax_gap + STATE_TOL, (t, interp_gap, jax_gap)
    assert bool(out.ok.all())
    assert all(fn.launches == n for fn, n in counts.items())


# ------------------------------------------------------------ K5's route


def test_pallas_interpret_backend_is_pallas_on_the_cpu():
    """``qp_backend="pallas_interpret"`` runs K5's plain version on either
    device; on the CPU so does ``"pallas"``: the two solves are bit for
    bit one, cold and warm, and no launch is counted."""
    rng = np.random.default_rng(2)
    b, n, m = 3, 12, 20
    g = rng.standard_normal((b, n, n))
    p = torch.tensor(g @ g.transpose(0, 2, 1) + np.eye(n))
    a = torch.tensor(rng.standard_normal((b, m, n)))
    q = torch.tensor(rng.standard_normal((b, n)))
    lo, hi = -torch.ones(b, m, dtype=F64), torch.ones(b, m, dtype=F64)
    before = admm_kernel.fused_admm.launches
    for warm in ({}, dict(x_warm=torch.full((b, n), 0.1, dtype=F64),
                          y_warm=torch.zeros(b, m, dtype=F64))):
        sols = [qp_admm.solve_qp(p, q, a, lo, hi, max_iter=150,
                                 backend=backend, **warm)
                for backend in ("pallas", "pallas_interpret")]
        assert _equal(*sols)
        assert bool(sols[0].solved.any())
    assert admm_kernel.fused_admm.launches == before
