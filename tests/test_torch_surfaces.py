"""The port's user-facing surfaces against the JAX package, float64 on the
CPU:

* the manipulability and its finite-difference and autodiff gradients
  (`models/kinematics.py`), within 1e-10;
* the plain RobotData route (``kin_backend="xla"``) for each ``mani_grad``
  and both systems against JAX `compute_robot_data(kin_backend="xla")`,
  within 1e-10, and the JAX ``ValueError`` where JAX raises it;
* `load_track_waypoints`, within 1e-12;
* `models/rigid_body.py` and every `compat` name, within 1e-10 of the
  output's scale;
* `sim.closed_loop_scan` (2 lanes, one of them at the track's end, so its
  end-point freeze fires) and `sim.ClosedLoopSim` against JAX's, states and
  inputs within 1e-8 (float64 closed loops, summation order only).

The port runs the bench configuration through its plain versions; JAX its
plain path of the same algorithm (tests/test_torch_mpc.py's ``JAX_CFG``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu import compat as jcompat
from mpcc_manipulator_tpu import sim as jsim
from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.models import rigid_body as jrb
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.params import load_params as j_load_params
from mpcc_manipulator_tpu.splines import arc_length as jals
from mpcc_manipulator_tpu.system import SYSTEMS as JSYSTEMS
from mpcc_manipulator_tpu_torch import compat, convert, sim
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.models import rigid_body
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import X0_HOME, X0_HOME_MOBILE
from mpcc_manipulator_tpu_torch.solver.sqp import check_supported
from mpcc_manipulator_tpu_torch.splines import arc_length as als
from mpcc_manipulator_tpu_torch.system import SYSTEMS
from tests.test_torch_mobile import _np
from tests.test_torch_mpc import JAX_CFG

torch.set_num_threads(1)

TOL = 1e-10          # one float64 evaluation, relative to the scale
STATE_TOL = 1e-8     # float64 closed loops
TS = 0.01
TRACK_FILE = "assets/tracks/track.json"


def _close(got, ref, what, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _configs(dof: int, n: int = 6, seed: int = 2) -> np.ndarray:
    home = (X0_HOME_MOBILE if dof == 10 else X0_HOME)[:dof]
    return home + 0.3 * np.random.default_rng(seed).standard_normal((n, dof))


# ------------------------------------------------------------ kinematics


@pytest.mark.parametrize("name", ["manipulability",
                                  "manipulability_gradient_fd",
                                  "manipulability_gradient_ad"])
def test_manipulability_matches_jax(name):
    qs = _configs(7)
    ref = jax.jit(jax.vmap(getattr(jkin, name)))(jnp.asarray(qs))
    _close(getattr(kin, name)(torch.tensor(qs)), ref, name)
    # batch-first over any leading shape
    got = getattr(kin, name)(torch.tensor(qs.reshape(2, 3, 7)))
    _close(got.reshape(np.shape(ref)), ref, name)


@pytest.mark.parametrize("mani_grad", ["fd", "ad", "analytic"])
@pytest.mark.parametrize("name", ["panda", "husky_panda"])
def test_plain_robot_data_matches_jax(name, mani_grad):
    """The plain kinematic route and the NN half, 2 scenarios x 5 knots, an
    obstacle near the arm (the mobile route takes the arm's autodiff
    gradient whatever ``mani_grad`` says, as in JAX)."""
    sy, jsy = SYSTEMS[name], JSYSTEMS[name]
    qs = _configs(sy.dof, 10).reshape(2, 5, sy.dof)
    obs = np.array([[0.5, 0.1, 0.4], [0.4, -0.2, 0.6]])
    radius = np.array([0.0, 3.0])
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    ref = jax.jit(jax.vmap(lambda q, o, r: j_robot_data(
        q, o, r, jsel, jenv, mani_grad=mani_grad, system=jsy,
        kin_backend="xla")))(jnp.asarray(qs), jnp.asarray(obs),
                             jnp.asarray(radius))
    got = compute_robot_data(
        torch.tensor(qs), torch.tensor(obs), torch.tensor(radius),
        cnn.load_self_collision_nn(device="cpu"),
        cnn.load_env_collision_nn(device="cpu"), mani_grad=mani_grad,
        system=sy, kin_backend="xla")
    for f in ref.__dataclass_fields__:
        r = np.asarray(getattr(ref, f))
        if f == "obs_radius":
            r = np.broadcast_to(r[:, None], (2, 5))
        else:
            # K2 and K3 read every kinematic and NN field row by row
            assert getattr(got, f).is_contiguous(), f
        _close(getattr(got, f), r, f)


def test_kin_route_raises_as_in_jax():
    """The K4 route computes the analytic gradient only: on the fixed base
    fd / ad there raise JAX's ValueError (in `compute_robot_data` and
    before a tick), on the mobile base they run, as in JAX."""
    import dataclasses
    qs = torch.tensor(_configs(7, 4)).reshape(1, 4, 7)
    nets = (cnn.load_self_collision_nn(device="cpu"),
            cnn.load_env_collision_nn(device="cpu"))
    obs, rad = torch.tensor([[3.0, 3.0, 3.0]]), torch.zeros(1)
    for grad in ("fd", "ad"):
        with pytest.raises(ValueError, match="analytic manipulability"):
            compute_robot_data(qs, obs, rad, *nets, mani_grad=grad,
                               system=SYSTEMS["panda"], kin_backend="pallas")
        with pytest.raises(ValueError, match="analytic manipulability"):
            j_robot_data(jnp.asarray(qs[0].numpy()), jnp.asarray([3.0] * 3),
                         0.0, jcnn.load_self_collision_nn(),
                         jcnn.load_env_collision_nn(), mani_grad=grad,
                         kin_backend="pallas")
        with pytest.raises(ValueError, match="analytic manipulability"):
            check_supported(dataclasses.replace(
                SQPConfig(qp_assembly="xla"), mani_grad=grad))
        check_supported(SQPConfig(mani_grad=grad), SYSTEMS["husky_panda"])
    with pytest.raises(ValueError, match="mani_grad"):
        compute_robot_data(qs, obs, rad, *nets, mani_grad="exact",
                           kin_backend="xla")


# ------------------------------------------------------------ track


def test_load_track_waypoints_matches_jax():
    ref = jals.load_track_waypoints(TRACK_FILE)
    got = als.load_track_waypoints(TRACK_FILE)
    for name, g, r in zip(("x", "y", "z", "rotations"), got, ref):
        assert g.dtype == np.float64
        _close(g, r, name, 1e-12)


# ------------------------------------------------------------ rigid body


def test_mass_matrix_matches_jax():
    qs = _configs(7, 4)
    ref = jax.jit(jax.vmap(jrb.mass_matrix))(jnp.asarray(qs))
    got = rigid_body.mass_matrix(torch.tensor(qs))
    _close(got, ref, "mass_matrix")
    # symmetric positive definite
    assert torch.allclose(got, got.transpose(-1, -2), atol=0)
    assert bool((torch.linalg.eigvalsh(got) > 0).all())


def test_nonlinear_effects_match_jax():
    qs, qds = _configs(7, 4), _configs(7, 4, seed=5) - X0_HOME[:7]
    ref = jax.jit(jax.vmap(jrb.nonlinear_effects))(jnp.asarray(qs),
                                                   jnp.asarray(qds))
    _close(rigid_body.nonlinear_effects(torch.tensor(qs), torch.tensor(qds)),
           ref, "nonlinear_effects")


# ------------------------------------------------------------ compat

_Q = X0_HOME[:7] + np.array([0.1, -0.2, 0.3, 0.1, -0.1, 0.2, 0.05])
_R = np.asarray(jkin.ee_orientation(jnp.asarray(_Q)))
_V = np.array([0.3, -0.5, 0.2])
_X = np.concatenate([_Q, [0.1, 0.2]])
_U = np.array([0.1, -0.2, 0.05, 0.3, -0.1, 0.2, 0.1, 0.4])

# name: (call on a compat module or its instances, arguments)
COMPAT = {
    "getSkewMatrix": (lambda m, **d: m.getSkewMatrix(_V, **d)),
    "getInverseSkewVector": (lambda m, **d: m.getInverseSkewVector(
        np.array([[0, -0.2, 0.5], [0.2, 0, -0.3], [-0.5, 0.3, 0]]), **d)),
    "LogMatrix": (lambda m, **d: m.LogMatrix(_R, **d)),
    "ExpMatrix": (lambda m, **d: m.ExpMatrix(
        np.array([[0, -0.2, 0.5], [0.2, 0, -0.3], [-0.5, 0.3, 0]]), **d)),
    "Log": (lambda m, **d: m.Log(_R, **d)),
    "Exp": (lambda m, **d: m.Exp(_V, **d)),
    "RotToQuat": (lambda m, **d: m.RotToQuat(_R, **d)),
    "QuatToRot": (lambda m, **d: m.QuatToRot([0.1, 0.7, -0.2, 0.5], **d)),
    "RobotModel.getEEJacobian": (
        lambda m, **d: m.RobotModel(**d).getEEJacobian(_Q)),
    "RobotModel.getEEJacobianv": (
        lambda m, **d: m.RobotModel(**d).getEEJacobianv(_Q)),
    "RobotModel.getEEJacobianw": (
        lambda m, **d: m.RobotModel(**d).getEEJacobianw(_Q)),
    "RobotModel.getEEPosition": (
        lambda m, **d: m.RobotModel(**d).getEEPosition(_Q)),
    "RobotModel.getEEOrientation": (
        lambda m, **d: m.RobotModel(**d).getEEOrientation(_Q)),
    "RobotModel.getEEManipulability": (
        lambda m, **d: m.RobotModel(**d).getEEManipulability(_Q)),
    "RobotModel.getDManipulability": (
        lambda m, **d: m.RobotModel(**d).getDManipulability(_Q)),
    "RobotModel.getMassMatrix": (
        lambda m, **d: m.RobotModel(**d).getMassMatrix(_Q)),
    "RobotModel.getNonlinearEffect": (
        lambda m, **d: m.RobotModel(**d).getNonlinearEffect(_Q, _U[:7])),
    "SelfCollisionNN": (lambda m, **d: m.SelfCollisionNN(
        **d).calculateMlpOutput(_Q)),
    "EnvCollisionNN": (lambda m, **d: m.EnvCollisionNN(
        **d).calculateMlpOutput(np.concatenate([_Q, [0.4, 0.2, 0.5]]))),
    "Integrator.simTimeStep": (
        lambda m, **d: m.Integrator(**d).simTimeStep(_X, _U)),
    "Integrator.RK4": (lambda m, **d: m.Integrator(**d).RK4(_X, _U, 0.01)),
    "Integrator.EF": (lambda m, **d: m.Integrator(**d).EF(_X, _U, 0.01)),
}


@pytest.mark.parametrize("name", list(COMPAT))
def test_compat_matches_jax(name):
    call = COMPAT[name]
    ref = call(jcompat)
    got = call(compat, device="cpu")
    for i, (g, r) in enumerate(zip(*((got, ref) if isinstance(ref, tuple)
                                     else ((got,), (ref,))))):
        _close(g, r, f"{name}[{i}]")


@pytest.mark.parametrize("name", ["getSkewMatrix", "QuatToRot",
                                  "RobotModel.getEEPosition",
                                  "SelfCollisionNN", "Integrator.RK4"])
def test_compat_defaults_to_the_card(name):
    """Each compat name computes on the card unless told the CPU: without a
    GPU the default call raises (no quiet CPU fallback)."""
    call = COMPAT[name]
    call(compat, device="cpu")
    if torch.cuda.is_available():
        call(compat)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call(compat)


# ------------------------------------------------------------ sim


@pytest.fixture(scope="module")
def loop_problem():
    """A closed circle track through the home EE position (start = end)
    at the home orientation (tests/test_mpc_e2e.py's), JAX and the port's
    copy."""
    jp, _ = j_load_params(dtype=jnp.float64)
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    q0 = jnp.asarray(X0_HOME[:7])
    ee = np.asarray(jkin.ee_position(q0))
    phi = np.linspace(0, 2 * np.pi, 100)
    jtrack = jals.gen_6d_spline(
        np.zeros(100) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2],
        np.tile(np.asarray(jkin.ee_orientation(q0)), (100, 1, 1)))
    port = (convert.track(_np(jtrack), device="cpu"),
            convert.mpcc_params(_np(jp), device="cpu"),
            convert.mlp(_np(jsel), device="cpu"),
            convert.mlp(_np(jenv), device="cpu"))
    return (jtrack, jp, jsel, jenv), port


def test_closed_loop_scan_matches_jax(loop_problem):
    """Lane 0 from the track's start, lane 1 at its end (s = length): lane
    1's end-point criterion fires after the first tick and it freezes, lane
    0 runs on; every output equals JAX's `closed_loop_scan` lane by
    lane."""
    (jtrack, jp, jsel, jenv), (track, params, sel, env) = loop_problem
    n_steps = 4
    x0 = np.stack([X0_HOME, X0_HOME])
    x0[1, 7] = float(jtrack.length)
    obs = jnp.asarray([3.0, 3.0, 3.0])
    refs = [jsim.closed_loop_scan(jtrack, jp, jsel, jenv, jnp.asarray(x), obs,
                                  0.0, n_steps=n_steps, ts=TS, cfg=JAX_CFG)
            for x in x0]
    got = sim.closed_loop_scan(track, params, sel, env, torch.tensor(x0),
                               torch.tensor([[3.0, 3.0, 3.0]] * 2),
                               torch.zeros(2, dtype=torch.float64),
                               n_steps=n_steps, ts=TS, cfg=SQPConfig())
    names = ("states", "inputs", "status", "ok", "finished")
    for lane, ref in enumerate(refs):
        for name, g, r in zip(names, got, ref):
            _close(g[lane].numpy(), np.asarray(r), f"{name}[{lane}]",
                   STATE_TOL)
    fin = got[4].numpy()
    assert not fin[0].any() and fin[1].all(), fin
    # the finished lane repeats its frozen state and input
    assert torch.equal(got[0][1, 1:], got[0][1, :1].expand(n_steps - 1, -1))
    assert torch.equal(got[1][1, 1:], got[1][1, :1].expand(n_steps - 1, -1))
    assert bool(got[3].all())


def test_closed_loop_sim_matches_jax(loop_problem):
    (jtrack, jp, jsel, jenv), (track, params, sel, env) = loop_problem
    n_steps = 4
    x_ref, log_ref = jsim.ClosedLoopSim(jtrack, jp, jsel, jenv, ts=TS,
                                        cfg=JAX_CFG).run(X0_HOME, n_steps)
    x_got, log_got = sim.ClosedLoopSim(track, params, sel, env,
                                       ts=TS).run(X0_HOME, n_steps)
    _close(x_got, x_ref, "final state", STATE_TOL)
    assert set(log_got) == set(log_ref)
    for key in log_ref:
        assert len(log_got[key]) == len(log_ref[key]) == n_steps, key
        if key != "solve_time":
            _close(np.asarray(log_got[key]), np.asarray(log_ref[key]), key,
                   STATE_TOL)
    assert all(t > 0 for t in log_got["solve_time"])
    assert log_got["s"][-1] > log_got["s"][0]
