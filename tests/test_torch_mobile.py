"""The Husky+Panda mobile path of the port against the JAX package, module by
module, on the CPU.

* kinematics (`models/kinematics_mobile.py`) against JAX
  `kinematics_mobile`, float64, atol 1e-12, at non-zero base yaw;
* K4's plain version at the mobile dims against the JAX kernel
  `kin_sweep(system=HUSKY_PANDA, interpret=True)`, float32, under the JAX
  kernel test's contract (tests/test_pallas_kinematics.py): atol 2e-6 on
  p, R, jv, jw; rtol 2e-5 / atol 1e-6 on m; rtol 2e-3 / atol 2e-4 on dm;
* RobotData against JAX `compute_robot_data(system=HUSKY_PANDA,
  kin_backend="xla")`, float64, atol 1e-10 (the JAX route takes the arm's
  manipulability gradient by AD, the port analytically);
* the stage QP (K2's plain version) and the line-search evaluation (K3's)
  against JAX `build_qp_stages_k` and `total_objective` +
  `constraint_values`, float64, each block within 1e-10 x its scale;
* the problem, the parameter loaders, the wrappers' CPU route and their
  refusal of dims they have no kernel instantiation for.

The structured IPM and the whole tick are held in
tests/test_torch_mobile_loop.py.  The CUDA instantiations themselves are compared with these plain versions
on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import kinematics_mobile as jkinm
from mpcc_manipulator_tpu.ocp import qp_data as jqd
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.ops import pallas_kinematics as pkin
from mpcc_manipulator_tpu.params import load_params as j_load_params
from mpcc_manipulator_tpu.solver.sqp import constraint_norm
from mpcc_manipulator_tpu.splines import arc_length as jals
from mpcc_manipulator_tpu.system import HUSKY_PANDA as JSYS
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kinm
from mpcc_manipulator_tpu_torch.ocp import qp_data, qp_stages
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
from mpcc_manipulator_tpu_torch.ops import cuda_build
from mpcc_manipulator_tpu_torch.ops.kinematics_kernel import (kin_sweep,
                                                              kin_sweep_plain)
from mpcc_manipulator_tpu_torch.params import SQPConfig, load_params
from mpcc_manipulator_tpu_torch.problem import X0_HOME_MOBILE, build_problem
from mpcc_manipulator_tpu_torch.solver import sqp
from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
    fact_floats, scratch_floats, slot_floats, solve_qp_ipm_k,
    solve_qp_ipm_plain)
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA as SYS
from mpcc_manipulator_tpu_torch.system import PANDA, System

torch.set_num_threads(1)

TS = 0.01
B = 3
NAMES = ["p_ee", "r_ee", "jv", "jw", "manipul", "d_manipul"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, what, tol):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _configs(b=2, k=4, seed=3, yaw=0.3):
    """Mobile configurations around the home pose: base (0.1, -0.2, yaw)
    and the arm's home, each + 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([[0.1, -0.2, yaw], X0_HOME_MOBILE[3:10]])
    return base + 0.3 * rng.standard_normal((b, k, 10))


# ------------------------------------------------------------ kinematics


@pytest.mark.parametrize("yaw", [0.0, 0.3, -2.0])
def test_mobile_kinematics_match_jax(yaw):
    qs = _configs(b=1, k=6, seed=1, yaw=yaw)[0]
    qs[0, :3] = [0.0, 0.0, yaw]          # one pure-yaw base pose
    q_t = torch.tensor(qs)
    for name, fn, jfn in (
            ("ee_position", kinm.ee_position, jkinm.ee_position),
            ("ee_orientation", kinm.ee_orientation, jkinm.ee_orientation),
            ("ee_jacobian", kinm.ee_jacobian, jkinm.ee_jacobian),
            ("manipulability", kinm.manipulability, jkinm.manipulability)):
        ref = np.asarray(jax.vmap(jfn)(jnp.asarray(qs)))
        got = fn(q_t).numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0, err_msg=name)


def test_k4_mobile_plain_matches_pallas_kernel_f32():
    qs = _configs()
    ref = jax.vmap(lambda q: pkin.kin_sweep(q, system=JSYS, interpret=True))(
        jnp.asarray(qs, dtype=jnp.float32))
    got = kin_sweep_plain(torch.tensor(qs, dtype=torch.float32), SYS)
    tol = [dict(atol=2e-6)] * 4 + [dict(rtol=2e-5, atol=1e-6),
                                   dict(rtol=2e-3, atol=2e-4)]
    for name, g, r, t in zip(NAMES, got, ref, tol):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **t)
    # manipulability is the arm's: zero gradient on the base columns
    assert bool((got[5][..., :3] == 0).all())


def _near_obstacle():
    ee = kinm.ee_position(torch.tensor(X0_HOME_MOBILE[:10])).numpy()
    return [ee[0] + 0.55, ee[1] - 0.25, ee[2]]


OBSTACLES = [pytest.param("far", id="far_obstacle"),
             pytest.param("near", id="near_obstacle")]


@pytest.mark.parametrize("where", OBSTACLES)
def test_mobile_robot_data_matches_jax(where):
    obs = [3.0, 3.0, 3.0] if where == "far" else _near_obstacle()
    qs = _configs(b=B, k=5, seed=6)
    radius = np.array([0.0, 3.0, 5.0])
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    ref = jax.vmap(lambda q, r: j_robot_data(
        q, jnp.asarray(obs), r, jsel, jenv, mani_grad="analytic",
        system=JSYS, kin_backend="xla"))(jnp.asarray(qs), jnp.asarray(radius))
    got = compute_robot_data(
        torch.tensor(qs), torch.tensor([obs] * B, dtype=torch.float64),
        torch.tensor(radius), cnn.load_self_collision_nn(device="cpu"),
        cnn.load_env_collision_nn(device="cpu"), mani_grad="analytic",
        system=SYS, kin_backend="pallas")
    for f in ref.__dataclass_fields__:
        r = np.asarray(getattr(ref, f), dtype=np.float64)
        g = getattr(got, f).numpy()
        if f == "obs_radius":
            r = np.broadcast_to(r[:, None], g.shape)
        assert g.shape == r.shape, f
        np.testing.assert_allclose(g, r, atol=1e-10, rtol=0, err_msg=f)
    # the env rows see the obstacle move with the base: non-zero base
    # columns, and zero base columns on the self-collision gradient
    assert float(np.abs(got.d_env_dist[..., :3].numpy()).max()) > 0
    assert bool((got.d_sel_dist[..., :3] == 0).all())


# ------------------------------------------------------------ stage QP


def _mobile_track(dtype):
    """The track of tests/test_qp_ipm_pallas_mobile.py: 0.8 m forward with
    a 0.12 m circle in y/z, at the home orientation."""
    x0 = np.concatenate([X0_HOME_MOBILE[:10], [0.05, 0.1]])
    ee = np.asarray(jkinm.ee_position(jnp.asarray(x0[:10])))
    rot = np.asarray(jkinm.ee_orientation(jnp.asarray(x0[:10])))
    nt = 60
    phi = np.linspace(0, 2 * np.pi, nt)
    return jals.gen_6d_spline(
        np.linspace(0, 0.8, nt) + ee[0], 0.12 * np.cos(phi) - 0.12 + ee[1],
        0.12 * np.sin(phi) + ee[2], np.tile(rot, (nt, 1, 1)), dtype=dtype), x0


@pytest.fixture(scope="module", params=["far", "near"],
                ids=["far_obstacle", "near_obstacle"])
def stage_case(request):
    jp, _ = j_load_params(dtype=jnp.float64, system=JSYS)
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    jtrack, x0 = _mobile_track(jnp.float64)
    rng = np.random.default_rng(11)
    zs = (np.concatenate([np.tile(x0, 11), np.zeros(SYS.nu * 10)])[None]
          + 0.002 * rng.standard_normal((B, SYS.n_var)))
    cu = 0.05 * rng.standard_normal((B, SYS.nu))
    obs = (np.array([3.0, 3.0, 3.0]) if request.param == "far"
           else np.array(_near_obstacle()))
    radius = np.array([0.0, 2.0, 4.0])

    def build(z, c, r):
        xs = z[:SYS.nx * 11].reshape(11, SYS.nx)
        rb = j_robot_data(xs[:, :SYS.dof], jnp.asarray(obs), r, jsel, jenv,
                          mani_grad="analytic", system=JSYS)
        qpk = jqs.build_qp_stages_k(jtrack, z, rb, jp, c, TS, False,
                                    system=JSYS)
        obj = jqd.total_objective(jtrack, z, rb, jp, system=JSYS)
        vio = constraint_norm(*jqd.constraint_values(jtrack, z, rb, jp, c, TS,
                                                     system=JSYS))
        return qpk, jqs.qpk_to_qps(qpk, system=JSYS), obj, vio

    ref = jax.jit(jax.vmap(build))(jnp.asarray(zs), jnp.asarray(cu),
                                   jnp.asarray(radius))
    track = convert.track(_np(jtrack), device="cpu")
    params = convert.mpcc_params(_np(jp), device="cpu")
    z = torch.tensor(zs)
    xs, _ = qp_data.split_z(z, SYS)
    rb = compute_robot_data(
        xs[..., :SYS.dof].contiguous(), torch.tensor(obs).expand(B, 3),
        torch.tensor(radius), convert.mlp(_np(jsel), device="cpu"),
        convert.mlp(_np(jenv), device="cpu"), mani_grad="analytic",
        system=SYS, kin_backend="pallas")
    return _np(ref), (track, z, rb, params, torch.tensor(cu))


def test_mobile_stage_qpk_blocks_match_jax(stage_case):
    (rqpk, _, _, _), (track, z, rb, params, cu) = stage_case
    qpk = ak.build_qp_stages_k_plain(track, z, rb, params, cu, TS,
                                     system=SYS)
    for f in rqpk.__dataclass_fields__:
        _close(getattr(qpk, f), getattr(rqpk, f), f, 1e-10)
        assert getattr(qpk, f).is_contiguous(), f
    rqps = stage_case[0][1]
    qps = qp_stages.qpk_to_qps(qpk, SYS)
    for f in rqps.__dataclass_fields__:
        _close(getattr(qps, f), getattr(rqps, f), f"qps.{f}", 1e-10)


def test_mobile_eval_point_matches_jax(stage_case):
    (_, _, robj, rvio), (track, z, rb, params, cu) = stage_case
    obj, vio = ak.eval_point_plain(track, z, rb, params, cu, TS, SYS)
    _close(obj, robj, "objective", 1e-10)
    _close(vio, rvio, "violation", 1e-10)


# ------------------------------------------------------------ problem


def _pairs(port_obj, jax_obj, name=""):
    """(name, port tensor, JAX array) for every tensor of a port dataclass
    tree and the same-named leaves of its JAX counterpart."""
    if isinstance(port_obj, torch.Tensor):
        yield name, port_obj, np.asarray(jax_obj)
        return
    for f in dataclasses.fields(port_obj):
        yield from _pairs(getattr(port_obj, f.name), getattr(jax_obj, f.name),
                          f"{name}.{f.name}")


def test_build_problem_matches_jax():
    from __graft_entry__ import _build_problem
    jtrack, jparams, *_ = _build_problem(jnp.float64, small=False,
                                         system=JSYS)
    track, params, sel_nn, env_nn = build_problem(torch.float64, "cpu",
                                                  system=SYS)
    n = 0
    for obj, jobj in ((track, jtrack), (params, jparams)):
        for name, g, r in _pairs(obj, jobj):
            assert tuple(g.shape) == r.shape, name
            np.testing.assert_allclose(g.numpy(), r, atol=1e-12, rtol=0,
                                       err_msg=name)
            n += 1
    assert n > 40
    # the 1.2 m forward track from the mobile home pose's EE
    assert abs(float(track.length) - float(jtrack.length)) < 1e-12
    assert float(track.length) > 1.2


@pytest.mark.parametrize("overrides", [None, {
    "bounds": {"dxbu": 0.5, "q1l": -2.0},
    "normalization": {"thb": 3.0}}], ids=["defaults", "overrides"])
def test_mobile_load_params_matches_jax(overrides):
    jp, _ = j_load_params(overrides=overrides, dtype=jnp.float64,
                          system=JSYS)
    p, _ = load_params(overrides=overrides, dtype=torch.float64,
                       device="cpu", system=SYS)
    for group, sizes in (("bounds", dict(x_l=12, x_u=12, u_l=11, u_u=11,
                                         ddq_l=10, ddq_u=10)),
                         ("normalization", dict(t_x=12, t_u=11))):
        for f, n in sizes.items():
            g = getattr(getattr(p, group), f).numpy()
            r = np.asarray(getattr(getattr(jp, group), f))
            assert g.shape == r.shape == (n,), (group, f)
            np.testing.assert_array_equal(g, r, err_msg=f"{group}.{f}")


def test_convert_carries_the_mobile_parameters_and_carry():
    """`convert` takes the JAX package's mobile parameters (bounds of
    length 12 / 11 / 10, normalization 12 / 11) and carry across."""
    from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
    from mpcc_manipulator_tpu_torch.mpc import init_carry
    jp, _ = j_load_params(dtype=jnp.float64, system=JSYS)
    p = convert.mpcc_params(_np(jp), device="cpu")
    for name, g, r in _pairs(p, jp):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert [p.bounds.x_l.numel(), p.bounds.u_l.numel(),
            p.bounds.ddq_l.numel()] == [12, 11, 10]
    assert [p.normalization.t_x.numel(), p.normalization.t_u.numel()] == [
        12, 11]
    jc = _np(jax.tree.map(lambda a: a[None], j_init_carry(jnp.float64, JSYS)))
    c = convert.carry(jc, device="cpu")
    ref = init_carry(1, torch.float64, "cpu", SYS)
    for f in dataclasses.fields(ref):
        g, r = getattr(c, f.name), getattr(ref, f.name)
        assert g.shape == r.shape and g.dtype == r.dtype, f.name
        assert torch.equal(g, r), f.name


# ------------------------------------------------------------ wrappers


def test_mobile_wrappers_take_plain_version_on_cpu(stage_case):
    """At the Husky shapes every wrapper runs its plain version on CPU
    tensors and launches nothing."""
    _, (track, z, rb, params, cu) = stage_case
    counts = lambda: dict(cuda_build.LAUNCHES)
    before = counts()
    for g, r in zip(kin_sweep(rb.q, SYS), kin_sweep_plain(rb.q, SYS)):
        assert torch.equal(g, r)
    got = ak.build_qp_stages_k_kernel(track, z, rb, params, cu, TS,
                                      system=SYS)
    ref = ak.build_qp_stages_k_plain(track, z, rb, params, cu, TS,
                                     system=SYS)
    assert all(torch.equal(getattr(got, f.name), getattr(ref, f.name))
               for f in dataclasses.fields(ref))
    zc = torch.stack([z, z + 1e-3], dim=1)
    for g, r in zip(ak.eval_point_kernel(track, zc, rb, params, cu, TS, SYS),
                    ak.eval_point_plain(track, zc, rb, params, cu, TS, SYS)):
        assert g.shape == (B, 2) and torch.equal(g, r)
    qpk = ak.build_qp_stages_k_plain(track, z, rb, params, cu, TS,
                                     system=SYS)
    got = solve_qp_ipm_k(qpk, system=SYS)
    ref = solve_qp_ipm_plain(qpk, system=SYS)
    assert torch.equal(got.du, ref.du) and torch.equal(got.iters, ref.iters)
    assert counts() == before


# K1's scratch per (scenario, stage): (fact_floats, slot_floats, adaptive,
# Mehrotra) -- the Panda's slots live in shared memory, the Husky+Panda's
# in the scratch (csrc/qp_ipm.cu, WIDE)
K1_SCRATCH = {PANDA.name: (161, 0, 0, 161), SYS.name: (287, 320, 320, 608)}


@pytest.mark.parametrize("system", [PANDA, SYS], ids=lambda s: s.name)
def test_k1_scratch_sizes_follow_the_dims(system):
    """The K1 wrapper's scratch sizes against the dims: Mehrotra's saved
    factorization is L (nu x nu), s_bar's x-columns (nu x nx), P_{k+1} e_k
    (nx + nu) and 1 / diag(L) (nu); a slot is the upper halves of Q_xx and
    R, S (nu x nx), the dof rate diagonals and the gradients gq (nx + dof)
    and gu (nu), padded to 4 floats; the factorization follows a slot at a
    4-float boundary."""
    nx, nu, dof = system.nx, system.nu, system.dof
    pad4 = lambda n: -(-n // 4) * 4
    fact = nu * nu + nu * nx + (nx + nu) + nu
    slot = pad4(nx * (nx + 1) // 2 + nu * (nu + 1) // 2 + nu * nx + dof
                + (nx + dof) + nu) if system.base_dof else 0
    mehrotra = slot + pad4(fact) if slot else fact
    got = (fact_floats(system), slot_floats(system),
           scratch_floats(system, "adaptive"),
           scratch_floats(system, "mehrotra"))
    assert got == (fact, slot, slot, mehrotra) == K1_SCRATCH[system.name]


ODD = System(name="odd", base_dof=2)


def test_wrappers_refuse_dims_without_an_instantiation():
    """A tensor off the CPU reaches the kernel instantiation of its system
    or raises: dims the kernels are not instantiated for raise before
    anything is launched."""
    meta = dict(dtype=torch.float32, device="meta")
    with pytest.raises(NotImplementedError, match="instantiation"):
        kin_sweep(torch.empty(2, 11, ODD.dof, **meta), ODD)
    with pytest.raises(NotImplementedError, match="instantiation"):
        ak.build_qp_stages_k_kernel(None, torch.empty(2, ODD.n_var, **meta),
                                    None, None, None, TS, system=ODD)
    with pytest.raises(NotImplementedError, match="instantiation"):
        ak.eval_point_kernel(None, torch.empty(2, ODD.n_var, **meta), None,
                             None, None, TS, ODD)
    qpk = qp_stages.StageQPK(**{f.name: torch.empty(2, 1, **meta)
                                for f in dataclasses.fields(qp_stages.StageQPK)})
    with pytest.raises(NotImplementedError, match="instantiation"):
        solve_qp_ipm_k(qpk, system=ODD)
    # a Panda-shaped tensor given the mobile system raises too
    with pytest.raises(ValueError, match="husky_panda"):
        kin_sweep_plain(torch.zeros(2, 11, 7), SYS)


def test_mobile_configuration_routes():
    """The bench configuration runs the mobile system; the dense ADMM path
    stays Panda-only with the JAX package's error, and the dense QP stays
    the Panda's."""
    sqp.check_supported(SQPConfig(), SYS)
    with pytest.raises(ValueError, match="Panda-only"):
        sqp.check_supported(SQPConfig(qp_solver="admm", qp_assembly="xla"),
                            SYS)
    assert PANDA.n_var == 179 and SYS.n_var == 242 and SYS.nc_stage == 77
