"""K2 and K3's CPU routes against the JAX package, float64 on the CPU.

The port's `build_qp_stages_k_kernel` and `eval_point_kernel` run their
plain versions on CPU tensors; here they are held to the JAX functions the
JAX kernel tests hold `_assembly_kernel` and `_eval_kernel` to
(`tests/test_pallas_assembly.py`): `build_qp_stages_k`, and
`total_objective` + `constraint_norm(constraint_values)`.  The inputs are
that test's track and state, in its three regions (interior knots with the
obstacle far away; endpoint and taper; obstacle near the EE with the RBF
rows active, and one lane's wrist near-singular so that the weight
scheduling fires), with one change: the track holds the home pose's tool-down
orientation (as `tests/test_torch_ocp.py` does) where the JAX test holds
the identity.  Against the identity the heading error lies within 3e-4 rad
of pi, where the rotation log's generic branch loses ~1e-9 relative to the
cancellation in 1 - cos^2 in float64, and the two packages' 3x3 products
round differently; `chip_smoke.py` checks K2 on that track.  Tolerance
1e-9 relative to each block's scale.  The kernels' packed table is held to
the JAX kernel's tables.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import collision_nn as jcnn
from mpcc_manipulator_tpu.models import kinematics as jkin
from mpcc_manipulator_tpu.ocp import qp_data as jqd
from mpcc_manipulator_tpu.ocp import qp_stages as jqs
from mpcc_manipulator_tpu.ocp.robot_data import \
    compute_robot_data as j_robot_data
from mpcc_manipulator_tpu.ops import pallas_assembly as jpasm
from mpcc_manipulator_tpu.params import load_params as j_load_params
from mpcc_manipulator_tpu.solver.sqp import constraint_norm as j_norm
from mpcc_manipulator_tpu.splines import arc_length as jals
from mpcc_manipulator_tpu_torch import convert
from mpcc_manipulator_tpu_torch.ocp import qp_data
from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak

torch.set_num_threads(1)

TS = 0.01
TOL = 1e-9
X0_P = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4, 0.05, 0.1])
A = 5     # candidates per scenario (the merit search's step lengths)


def _close(got, ref, what):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.fixture(scope="module")
def setup():
    """The JAX kernel test's problem (`tests/test_pallas_assembly.py`),
    tool-down track orientation."""
    jp, _ = j_load_params(dtype=jnp.float64)
    jsel = jcnn.load_self_collision_nn(dtype=jnp.float64)
    jenv = jcnn.load_env_collision_nn(dtype=jnp.float64)
    ee = np.asarray(jkin.ee_position_host(X0_P[:7]))
    nt = 60
    phi = np.linspace(0, 2 * np.pi, nt)
    jtrack = jals.gen_6d_spline(
        np.linspace(0, 0.3, nt) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2],
        np.tile(np.diag([1.0, -1.0, -1.0]), (nt, 1, 1)))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    port = dict(track=convert.track(np_tree(jtrack), device="cpu"),
                params=convert.mpcc_params(np_tree(jp), device="cpu"),
                sel=convert.mlp(np_tree(jsel), device="cpu"),
                env=convert.mlp(np_tree(jenv), device="cpu"))
    return (jtrack, jp, jsel, jenv), port, ee


REGIONS = ["interior", "endpoint_taper", "obstacle_scheduling"]


@pytest.fixture(scope="module", params=REGIONS)
def region(request, setup):
    """Both packages' blocks and values at one region's iterates."""
    (jtrack, jp, jsel, jenv), port, ee = setup
    length = float(jtrack.length)
    s_values, obs, radius = {
        "interior": ([0.05, 0.3, 0.6], [3.0, 3.0, 3.0], 0.0),
        "endpoint_taper": ([length - 0.05, length - 0.005, length + 0.1],
                           [3.0, 3.0, 3.0], 0.0),
        "obstacle_scheduling": ([0.02, 0.1, 0.2],
                                [ee[0] + 0.18, ee[1], ee[2]], 5.0),
    }[request.param]
    rng = np.random.default_rng(7)
    b = len(s_values)
    z0 = np.concatenate([np.tile(X0_P, 11), np.zeros(80)])
    zs = np.tile(z0, (b, 1)) + 0.002 * rng.standard_normal((b, 179))
    for i, sv in enumerate(s_values):
        for k in range(11):
            zs[i, k * 9 + 7] = sv + 0.003 * k
            if request.param == "obstacle_scheduling" and i == 0:
                zs[i, k * 9 + 5] = 0.05   # wrist near-singular: m ~ 0.018
    # the line search's trial points: 0.02-perturbed, so bound, rate and
    # defect rows really violate
    zt = zs + 0.02 * rng.standard_normal((b, 179))
    zc = zt[:, None] + 0.01 * rng.standard_normal((b, A, 179))
    cu = 0.02 * rng.standard_normal((b, 8))

    def ref(z, ztry, c):
        rb = j_robot_data(z[:99].reshape(11, 9)[:, :7], jnp.asarray(obs),
                          radius, jsel, jenv, mani_grad="analytic")
        qpk = jqs.build_qp_stages_k(jtrack, z, rb, jp, c, TS, False)
        obj = jqd.total_objective(jtrack, ztry, rb, jp)
        vio = j_norm(*jqd.constraint_values(jtrack, ztry, rb, jp, c, TS))
        return qpk, obj, vio

    jref = jax.jit(jax.vmap(ref))(jnp.asarray(zs), jnp.asarray(zt),
                                  jnp.asarray(cu))
    z = torch.tensor(zs)
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.tensor(obs).expand(b, 3),
                            torch.full((b,), radius, dtype=torch.float64),
                            port["sel"], port["env"], mani_grad="analytic", kin_backend="pallas")
    return dict(jref=jref, z=z, zt=torch.tensor(zt), zc=torch.tensor(zc),
                rb=rb, cu=torch.tensor(cu), track=port["track"],
                params=port["params"], region=request.param)


def test_assembly_cpu_route_matches_jax(region):
    r = region
    ref = r["jref"][0]
    qpk = ak.build_qp_stages_k_kernel(r["track"], r["z"], r["rb"],
                                      r["params"], r["cu"], TS)
    for f in dataclasses.fields(qpk):
        _close(getattr(qpk, f.name), getattr(ref, f.name), f.name)
    if r["region"] == "obstacle_scheduling":
        # an env row's barrier is active (h < 0), and the weights are
        # scheduled (ratio <= 1) on the near-singular lane
        rb, m = r["rb"], r["params"].model
        env_h = (0.01 * (rb.env_dist - 1.2 * rb.obs_radius[..., None])
                 - 0.01 * m.tol_envcol)
        ratio = torch.minimum(rb.sel_dist / (m.tol_selcol * 2.0),
                              rb.manipul / (m.tol_sing * 2.0))
        assert float(env_h.min()) < 0.0 and float(ratio.min()) < 1.0


def test_eval_cpu_route_matches_jax(region):
    r = region
    _, robj, rvio = r["jref"]
    obj, vio = ak.eval_point_kernel(r["track"], r["zt"], r["rb"],
                                    r["params"], r["cu"], TS)
    _close(obj, robj, "objective")
    _close(vio, rvio, "violation")
    assert float(vio.max()) > 0.1        # the perturbation really violates


def test_eval_candidate_axis_equals_separate_calls(region):
    r = region
    obj, vio = ak.eval_point_kernel(r["track"], r["zc"], r["rb"],
                                    r["params"], r["cu"], TS)
    assert obj.shape == vio.shape == (r["z"].shape[0], A)
    for a in range(A):
        o, v = ak.eval_point_kernel(r["track"], r["zc"][:, a].contiguous(),
                                    r["rb"], r["params"], r["cu"], TS)
        assert torch.equal(obj[:, a], o) and torch.equal(vio[:, a], v), a


def test_pack_tables_matches_jax_kernel_tables(setup):
    """The packed table holds the JAX kernel's scalar vector
    (`_pack_scalars`), bounds, scalings, Ad/Bd and coefficient tables."""
    (jtrack, jp, _, _), port, _ = setup
    tbl = ak.pack_tables(port["track"], port["params"], TS).double()
    n_sc = len(ak.SC_KEYS)
    sc = np.asarray(jpasm._pack_scalars(jtrack, jp, jnp.float32))[:, 0]
    assert tbl.dtype == torch.float64 and n_sc == sc.size
    np.testing.assert_array_equal(tbl[:n_sc].numpy(), sc)
    from mpcc_manipulator_tpu.ocp.qp_data import _discrete_ab
    ad, bd = _discrete_ab(TS, jnp.float64)
    nrm, bnd = jp.normalization, jp.bounds
    nseg = jtrack.sx.a.shape[0]
    ptbl = np.stack([getattr(getattr(jtrack, ch), f)
                     for ch in ("sx", "sy", "sz") for f in "abcd"], axis=1)
    m = nseg - 1
    rtbl = np.concatenate([np.asarray(jtrack.sr.r[:m]).reshape(m, 9),
                           jtrack.sr.omega, np.asarray(jtrack.sr.c)[:, None],
                           np.asarray(jtrack.sr.d)[:, None]], axis=1)
    rest = np.concatenate([np.ravel(v) for v in (
        nrm.t_x, nrm.t_u, bnd.x_l, bnd.x_u, bnd.u_l, bnd.u_u, bnd.ddq_l,
        bnd.ddq_u, ad, bd, ptbl, rtbl)]).astype(np.float32)
    np.testing.assert_array_equal(tbl[n_sc:].numpy(), rest)


def test_tables_follow_parameter_edits(setup):
    """The cached table and shared blocks are rebuilt after a parameter
    tensor is edited in place or replaced, and reused otherwise."""
    _, port, _ = setup
    track, params = port["track"], copy.deepcopy(port["params"])
    q_c = ak.SC_KEYS.index("q_c")
    tbl, shared = ak.tables(track, params, TS)
    assert ak.tables(track, params, TS)[0] is tbl
    params.cost.q_c.mul_(2.0)
    tbl2, _ = ak.tables(track, params, TS)
    assert float(tbl2[q_c]) == 2.0 * float(tbl[q_c])
    params.cost.q_c = torch.tensor(5.0, dtype=torch.float64)
    assert float(ak.tables(track, params, TS)[0][q_c]) == 5.0
    params.cost.r_ddq.add_(1.0)
    r2 = ak.tables(track, params, TS)[1]["r2"]
    torch.testing.assert_close(r2[1:], shared["r2"][1:] * (
        float(params.cost.r_ddq) / (float(params.cost.r_ddq) - 1.0)))


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors: another
    device either launches the kernel (CUDA) or raises."""
    meta = torch.empty(2, 179, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ak.build_qp_stages_k_kernel(None, meta, None, None, None, TS)
    with pytest.raises(ValueError, match="unsupported device"):
        ak.eval_point_kernel(None, meta, None, None, None, TS)


# ---------------------------------------------------------------- the launch
# geometry and the wrapper's per-batch cache (no card needed)

from mpcc_manipulator_tpu_torch.mpc import _cold_start  # noqa: E402
from mpcc_manipulator_tpu_torch.ocp import qp_stages as tqs  # noqa: E402
from mpcc_manipulator_tpu_torch.problem import (  # noqa: E402
    X0_HOME, X0_HOME_MOBILE, build_problem)
from mpcc_manipulator_tpu_torch.system import (  # noqa: E402
    HUSKY_PANDA, PANDA)

SYSTEMS = {"panda": PANDA, "husky_panda": HUSKY_PANDA}


@pytest.mark.parametrize("n_h", [5, 10, 20])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_launch_geometry_fits_the_budget(system, n_h):
    """K2 and K3 (one and five candidates) hold whole scenarios a block in
    at most 48 KB of shared memory, and the Panda's batch 1024 gives every
    one of the H100's 132 SMs a block."""
    sy = SYSTEMS[system]
    for kernel, cand in ((2, 1), (3, 1), (3, 5)):
        g = ak.launch_geometry(kernel, sy, n_h, cand, 1024)
        assert g["shared_bytes"] <= 48 * 1024, (kernel, cand, g)
        assert g["rows_per_block"] == g["scenarios_per_block"] * cand, g
        assert g["threads"] >= (g["rows_per_block"] * (n_h + 1)
                                if kernel == 3 else 1), g
        assert g["blocks"] == -(-1024 // g["scenarios_per_block"]), g
        if sy is PANDA:
            assert g["blocks"] >= 132, (kernel, cand, g)


def test_launch_geometry_splits_many_candidates():
    """A scenario whose candidates need more than a block's 128 threads is
    split over blocks of whole candidate rows; shapes no block fits
    raise."""
    g = ak.launch_geometry(3, PANDA, 10, 13, 7)
    assert g["rows_per_block"] == 11 and g["blocks"] == -(-7 * 13 // 11)
    assert g["threads"] == 128 and g["shared_bytes"] <= 48 * 1024
    with pytest.raises(ValueError, match="no block fits"):
        ak.launch_geometry(2, HUSKY_PANDA, 60)


def _stage_qp(system, b, params=None):
    """The plain assembly at ``b`` perturbed home states, float64 (at
    ``params``, the problem's by default)."""
    track, own, sel, env = build_problem(torch.float64, "cpu", system=system)
    params = own if params is None else params
    home = X0_HOME if system is PANDA else X0_HOME_MOBILE
    rng = np.random.default_rng(3)
    x0 = torch.tensor(home[None] + 0.01 * rng.standard_normal(
        (b, home.size)))
    z = _cold_start(x0, system)
    xs, _ = qp_data.split_z(z, system)
    rb = compute_robot_data(xs[..., :system.dof].contiguous(),
                            torch.full((b, 3), 3.0, dtype=torch.float64),
                            torch.zeros(b, dtype=torch.float64), sel, env,
                            mani_grad="analytic", system=system,
                            kin_backend="pallas")
    cu = torch.zeros(b, system.nu, dtype=torch.float64)
    return track, params, tqs.build_qp_stages_k(track, z, rb, params, cu, TS,
                                                system=system)


_BATCH_FIELDS = ("a_sv", "bd", "tx", "tu", "t_rate", "r2", "hux")


@pytest.mark.parametrize("b", [2, 5])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_batch_blocks_equal_the_plain_assembly(system, b):
    """The cached, batch-expanded shared blocks and the zero hux are the
    plain assembly's, at each batch size, in float64."""
    sy = SYSTEMS[system]
    track, params, ref = _stage_qp(sy, b)
    got = ak.batch_blocks(ak._entry(track, params, TS, sy), b, sy)
    assert sorted(got) == sorted(_BATCH_FIELDS)
    for f in _BATCH_FIELDS:
        r = getattr(ref, f)
        assert got[f].dtype == r.dtype and got[f].is_contiguous(), f
        torch.testing.assert_close(got[f], r, rtol=0.0, atol=1e-15)


@pytest.mark.parametrize("field", ["r_ddq", "t_u"])
def test_batch_blocks_follow_in_place_edits(field):
    """An in-place edit of r_ddq or t_u builds the batch blocks anew, equal
    to the plain assembly's at the edited parameters."""
    sy = PANDA
    track, params, _ = _stage_qp(sy, 3)
    params = copy.deepcopy(params)
    before = ak.batch_blocks(ak._entry(track, params, TS, sy), 3, sy)
    if field == "r_ddq":
        params.cost.r_ddq.mul_(3.0)
        moved = ("r2",)
    else:
        params.normalization.t_u.mul_(1.5)
        moved = ("tu", "bd", "t_rate", "r2")
    after = ak.batch_blocks(ak._entry(track, params, TS, sy), 3, sy)
    _, _, ref = _stage_qp(sy, 3, params)
    for f in _BATCH_FIELDS:
        torch.testing.assert_close(after[f], getattr(ref, f), rtol=0.0,
                                   atol=1e-15)
    for f in moved:
        assert not torch.equal(after[f], before[f]), f


def test_batch_blocks_are_reused_at_one_batch():
    """Two calls at one batch size return the same tensors; another batch
    size gets its own."""
    track, params, _ = _stage_qp(PANDA, 2)
    first = ak.batch_blocks(ak._entry(track, params, TS, PANDA), 4, PANDA)
    again = ak.batch_blocks(ak._entry(track, params, TS, PANDA), 4, PANDA)
    other = ak.batch_blocks(ak._entry(track, params, TS, PANDA), 6, PANDA)
    assert all(again[f] is first[f] for f in _BATCH_FIELDS)
    assert all(other[f].shape[0] == 6 for f in _BATCH_FIELDS)
