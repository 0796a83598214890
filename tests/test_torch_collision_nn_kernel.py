"""K7 (`ops/collision_nn_kernel.py`): the collision networks' forward pass
and input Jacobian, one launch a network.

On the CPU: the wrapper's route is the plain version for CPU tensors and
for ``interpret=True`` (and under ``mm_dtype="bfloat16"``), and
``interpret=False`` raises there; RobotData's NN half equals, bit for bit,
the eager code the kernel replaced, on both systems; the plain version's
``nn_units_active`` count is the masks' and a counting ``PhaseTimer``
reads it; the packed weights, read as the kernel reads them (a float64
emulation of its schedule: the stream's chunks, the row quads of W_out,
the forward over each knot's nonzero inputs and the Jacobian over its
units with z > 0), give the plain route's outputs, NaN where a NaN
configuration gives NaN.

On the card (marker ``card``; skipped without one): K7 against the plain
version lane by lane, both systems, float32 and float64, at the three
benchmark cells' knot counts and at batch 1, with a NaN lane; one launch a
network a tick, no host sync inside ``robot_data.nn`` and no cuBLAS
product in the networks on the bench route.  There the conftest's JAX
import is not wanted, so run them with

    python -m pytest tests/test_torch_collision_nn_kernel.py -m card \\
        --noconftest -q

Tolerances (card): float32 bit for bit (NaN where NaN) from 5,632 knots
(512 lanes) on, where cuBLAS runs every product of the plain route as one
FMA chain from k = 0 and the self network's output by the gemv partition
K7 follows (`collision_nn_kernel.out_order`); below that cuBLAS splits k
(gemmSN, split-K) and K7 agrees to rounding: 2e-6 of each output's
scale.  Float64: the DGEMMs' order is matched at the cells' sizes but not
everywhere, so 1e-14 of the scale.
"""

import contextlib

import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kinm
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ocp import robot_data as rd
from mpcc_manipulator_tpu_torch.ops import collision_nn_kernel as nnk
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import (X0_HOME, X0_HOME_MOBILE,
                                                build_problem)
from mpcc_manipulator_tpu_torch.solver import sqp_debug
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA

torch.set_num_threads(1)

SYSTEMS = [PANDA, HUSKY_PANDA]
SPHERE = (0.705, 0.075, 0.809)


def knots(system, b: int, k: int = 11, sigma: float = 0.1, seed: int = 0,
          dtype=torch.float64, device="cpu") -> torch.Tensor:
    """``qs`` (B, K, dof): the system's home + sigma N(0, 1)."""
    rng = np.random.default_rng(seed)
    home = (X0_HOME_MOBILE if system.base_dof else X0_HOME)[:system.dof]
    q = home + sigma * rng.standard_normal((b, k, system.dof))
    return torch.tensor(q, dtype=dtype, device=device)


def obstacles(b: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Every other scenario's obstacle far away (3, 3, 3), the rest at the
    benchmark's sphere."""
    obs = torch.tensor([(3.0, 3.0, 3.0), SPHERE] * b, dtype=dtype,
                       device=device)
    return obs[:b].contiguous()


def nets(dtype=torch.float64, device="cpu"):
    return (cnn.load_self_collision_nn(dtype, device),
            cnn.load_env_collision_nn(dtype, device))


def _parent_nn_half(qs, obs_pos, sel_nn, env_nn, system):
    """RobotData's NN half as it stood before K7."""
    b, k, dof = qs.shape
    q_flat = qs.reshape(b * k, dof)
    q_arm = q_flat[:, system.arm_slice]
    sel, d_sel = cnn.mlp_forward_jacobian(sel_nn, q_arm)
    d_sel = d_sel[:, 0]
    if system.base_dof != 0:
        d_sel = torch.cat([d_sel.new_zeros(b * k, system.base_dof), d_sel],
                          dim=-1)
    sel, d_sel = sel[:, 0].reshape(b, k), d_sel.reshape(b, k, dof)
    obs = obs_pos[:, None, :].expand(b, k, 3).reshape(b * k, 3)
    if system.base_dof == 0:
        env, d_env_full = cnn.mlp_forward_jacobian(
            env_nn, torch.cat([q_arm, obs], dim=-1))
        d_env = d_env_full[:, :, :dof]
    else:
        rb, pb = kinm._base_transform(q_flat[:, :3])
        rel = obs - pb
        rbt = rb.transpose(-1, -2)
        obs_local = (rbt @ rel[..., None])[..., 0]
        env, d_env_full = cnn.mlp_forward_jacobian(
            env_nn, torch.cat([q_arm, obs_local], dim=-1))
        arm = system.arm_dof
        d_env_q, d_env_o = d_env_full[:, :, :arm], d_env_full[:, :, arm:]
        c, s = torch.cos(q_flat[:, 2]), torch.sin(q_flat[:, 2])
        z = torch.zeros_like(c)
        drt_dth = torch.stack([torch.stack([-s, c, z], -1),
                               torch.stack([-c, -s, z], -1),
                               torch.stack([z, z, z], -1)], -2)
        d_obs_local = torch.cat([-rbt[:, :, :2], (drt_dth @ rel[..., None])],
                                dim=-1)
        d_env = torch.cat([d_env_o @ d_obs_local, d_env_q], dim=-1)
    n_links = env.shape[-1]
    return (sel, d_sel, env.reshape(b, k, n_links),
            d_env.reshape(b, k, n_links, dof).contiguous())


def calls(system, qs, obs_pos, sel_nn, env_nn):
    """The two wrapper calls RobotData makes: ``[(net, q, arm_offset, obs,
    obs_div, cols, offset)]``."""
    b, k, dof = qs.shape
    q = qs.reshape(b * k, dof)
    base = system.base_dof
    if base == 0:
        env = (env_nn, q, 0, obs_pos, k, dof, 0)
    else:
        obs = obs_pos[:, None, :].expand(b, k, 3).reshape(b * k, 3)
        rb, pb = kinm._base_transform(q[:, :3])
        local = (rb.transpose(-1, -2) @ (obs - pb)[..., None])[..., 0]
        env = (env_nn, q, base, local.contiguous(), 1, system.arm_dof + 3, 0)
    return [(sel_nn, q, base, None, 1, system.arm_dof, base), env]


def _equal(got, ref) -> bool:
    """Equal lane by lane, NaN where NaN (+0 and -0 equal)."""
    return (got.shape == ref.shape
            and bool(((got == ref) | (torch.isnan(got) & torch.isnan(ref)))
                     .all()))


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("flag", [None, True])
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_route_is_plain_on_the_cpu(system, flag):
    """On CPU tensors ``interpret=None`` and ``True`` run the plain version
    bit for bit; no launch counts."""
    sel_nn, env_nn = nets()
    qs = knots(system, 3)
    before = nnk.forward_jacobian.launches
    for net, q, off, obs, div, cols, offset in calls(system, qs,
                                                     obstacles(3), sel_nn,
                                                     env_nn):
        got = nnk.forward_jacobian(net, q, off, obs, div, cols=cols,
                                   offset=offset, interpret=flag, count=True)
        ref = nnk.forward_jacobian_plain(net, q, off, obs, div, cols=cols,
                                         offset=offset, count=True)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert nnk.forward_jacobian.launches == before


@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_interpret_false_raises_on_the_cpu(system):
    sel_nn, env_nn = nets()
    qs = knots(system, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        rd.compute_robot_data(qs, obstacles(2), torch.zeros(2), sel_nn,
                              env_nn, "fd", system, "xla",
                              kin_interpret=False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_nn_half_unchanged_on_the_cpu(system, dtype):
    """RobotData's NN half, through the wrapper's plain route, equals bit
    for bit the eager code it replaced (near and far obstacles, a NaN
    knot), in the layout K2 and K3 read."""
    sel_nn, env_nn = nets(dtype)
    qs = knots(system, 4, dtype=dtype)
    qs[1, 3, 2] = float("nan")
    obs = obstacles(4, dtype)
    got = rd._nn_half(qs, obs, sel_nn, env_nn, system)
    ref = _parent_nn_half(qs, obs, sel_nn, env_nn, system)
    assert all(_equal(a, b) for a, b in zip(got, ref))
    assert got[3].is_contiguous()


def test_bf16_route_is_the_plain_products():
    """``mm_dtype="bfloat16"`` runs the plain version's bf16 products."""
    sel_nn, env_nn = nets(torch.float32)
    qs = knots(PANDA, 2, dtype=torch.float32)
    for net, q, off, obs, div, cols, offset in calls(PANDA, qs,
                                                     obstacles(2,
                                                               torch.float32),
                                                     sel_nn, env_nn):
        y, jac, _ = nnk.forward_jacobian(net, q, off, obs, div, cols=cols,
                                         offset=offset, mm_dtype="bfloat16")
        x = q[:, :7] if obs is None else torch.cat(
            [q[:, :7], obs.repeat_interleave(div, 0)], -1)
        y_ref, jac_ref = cnn.mlp_forward_jacobian(net, x, "bfloat16")
        assert torch.equal(y, y_ref) and torch.equal(jac, jac_ref[:, :, :cols])


def test_plain_counts_are_the_masks_and_the_timer_reads_them():
    """``count=True`` gives each row's hidden units with z > 0, counted
    here from an independent forward pass; a counting ``PhaseTimer`` keeps
    their share of the dense count as ``nn_units_active`` on each network's
    span, and an uncounting one keeps nothing."""
    sel_nn, env_nn = nets()
    qs = knots(PANDA, 3)
    obs = obstacles(3)
    for net, q, off, obs_, div, cols, offset in calls(PANDA, qs, obs, sel_nn,
                                                      env_nn):
        _, _, counts = nnk.forward_jacobian_plain(net, q, off, obs_, div,
                                                  cols=cols, count=True)
        x = q[:, :7] if obs_ is None else torch.cat(
            [q[:, :7], obs_.repeat_interleave(div, 0)], -1)
        h, want = cnn.nerf_encode(x), 0
        for lin in net.layers[:-1]:
            z = lin(h)
            want = want + (z > 0).sum(-1)
            h = torch.relu(z)
        assert torch.equal(counts, want.to(torch.int32))
        assert counts.dtype == torch.int32
    for counting in (True, False):
        timer = sqp_debug.PhaseTimer("cpu", count_ops=counting)
        with timer.phase("tick"):
            rd.compute_robot_data(qs, obs, torch.zeros(3), sel_nn, env_nn,
                                  "analytic", PANDA, "pallas", timer=timer)
        for span, net in (("robot_data.nn.sel", sel_nn),
                          ("robot_data.nn.env", env_nn)):
            got = timer.counter("nn_units_active", span)
            if not counting:
                assert got is None
                continue
            q = qs.reshape(-1, 7)
            o = None if net is sel_nn else obs
            _, _, counts = nnk.forward_jacobian_plain(
                net, q, 0, o, 11, cols=7, count=True)
            share = counts.double().mean() / nnk.dense_units(net)
            assert got["lane_ticks"] == 33
            assert got["per_lane_tick"] == pytest.approx(float(share),
                                                         rel=1e-6)
            assert 0.2 < got["per_lane_tick"] < 0.45


def _unpack(net, dtype):
    """The weights as the kernel reads them from the pack: ``(W_0 .. W_out,
    b_0 .. b_out)`` from the stream's forward chunks, with the Jacobian's
    chunks checked against them."""
    lay = nnk.pack_layout(net, dtype)
    ce = lay["chunk_elems"]
    packed = nnk.pack(net)
    ws = [lin.weight for lin in net.layers]
    nh = len(ws) - 1
    shapes = ([w.T.shape for w in ws[:nh]]
              + [ws[l].shape for l in range(nh - 1, 0, -1)]
              + [(ws[0].shape[0], nnk.EPAD)])
    mats, at = [], 0
    for rows, cols in shapes:
        rpc = ce // cols
        n = -(-rows // rpc) * rpc
        mats.append(packed[at:at + n * cols].reshape(n, cols)[:rows])
        at += n * cols
    assert at == lay["chunks"] * ce
    fwd = [m.T for m in mats[:nh]]
    for l, m in zip(range(nh - 1, 0, -1), mats[nh:2 * nh - 1]):
        assert torch.equal(m, fwd[l])
    assert torch.equal(mats[-1][:, :fwd[0].shape[1]], fwd[0])
    assert not mats[-1][:, fwd[0].shape[1]:].any()
    res = packed[at:]
    n_out, width = ws[-1].shape
    nq = lay["row_quads"]
    quads = res[:4 * nq * width].reshape(nq, width, 4).transpose(1, 2)
    w_out = torch.cat([quads.reshape(4 * nq, width),
                       res[4 * nq * width:n_out * width].reshape(-1, width)])
    biases, at = [], n_out * width
    for lin in net.layers:
        biases.append(res[at:at + lin.out_features])
        at += lin.out_features
    assert at == lay["resident"] == res.numel()
    return fwd + [w_out], biases


def _emulate(ws, bs, x):
    """K7's arithmetic in float64 on the unpacked weights: the forward over
    each knot's nonzero (or NaN) activations, the Jacobian over its units
    with z > 0 only, through the encoding."""
    h = cnn.nerf_encode(x)
    pos = []
    for w, b in zip(ws[:-1], bs[:-1]):
        z = h @ w.T + b
        pos.append(z > 0)
        h = torch.where(z > 0, z, torch.where(torch.isnan(z), z,
                                              torch.zeros_like(z)))
    y = h @ ws[-1].T + bs[-1]
    jac = ws[-1].expand(x.shape[0], -1, -1)
    for w, p in zip(reversed(ws[:-1]), reversed(pos)):
        jac = torch.where(p[:, None, :], jac, torch.zeros_like(jac)) @ w
    n = x.shape[-1]
    return y, (jac[..., :n] + jac[..., n:2 * n] * torch.cos(x)[:, None, :]
               - jac[..., 2 * n:] * torch.sin(x)[:, None, :])


def test_pack_read_as_the_kernel_reads_it_gives_the_plain_outputs():
    """Both networks: the pack's stream and resident block, unpacked by the
    kernel's layout (the C entry's `mpcc_nn_layout` reports the same on the
    card), hold the networks' weights; K7's arithmetic on them gives the
    plain route's outputs within float64 rounding and NaN exactly where it
    does (a NaN joint, an infinite obstacle coordinate)."""
    for net, n_in in zip(nets(), (7, 10)):
        lay = nnk.pack_layout(net, torch.float64)
        assert lay["chunk_elems"] == nnk.SLOT_BYTES // 8
        ws, bs = _unpack(net, torch.float64)
        x = knots(PANDA, 1, k=40)[0]
        if n_in == 10:
            x = torch.cat([x, obstacles(40)], -1)
            x[5, 8] = float("inf")
        x[3, 2] = float("nan")
        y, jac = _emulate(ws, bs, x)
        y_ref, jac_ref = cnn.mlp_forward_jacobian(net, x)
        for got, ref in ((y, y_ref), (jac, jac_ref)):
            assert torch.equal(torch.isnan(got), torch.isnan(ref))
            fin = ~torch.isnan(ref)
            scale = ref[fin].abs().max()
            assert float((got[fin] - ref[fin]).abs().max()) <= 1e-12 * scale
        assert torch.isnan(y[3]).all() and torch.isnan(jac[3, :, 2]).all()
        assert not torch.isnan(jac[3, :, :2]).any()


def test_layouts_and_registration():
    """The pack's layout for both networks in both dtypes, the row-quad
    order, the gemv orders by size, K7 among the traced kernels."""
    sel_nn, env_nn = nets(torch.float32)
    assert nnk.pack_layout(env_nn, torch.float32) == dict(
        chunks=100, chunk_elems=4096, resident=9 * 256 + 1024 + 9,
        row_quads=2)
    assert nnk.pack_layout(sel_nn, torch.float32) == dict(
        chunks=12, chunk_elems=4096, resident=64 + 320 + 1, row_quads=0)
    assert nnk.pack_layout(env_nn, torch.float64)["chunks"] == 200
    assert nnk.pack(env_nn).numel() == 100 * 4096 + 3337
    w = torch.arange(27.0).reshape(9, 3)
    assert nnk.row_quads(w).tolist() == [0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8,
                                         11, 12, 15, 18, 21, 13, 16, 19, 22,
                                         14, 17, 20, 23, 24, 25, 26]
    assert nnk.out_order(11) == (32, 1, 1) and nnk.out_order(1727) == (32, 1, 1)
    assert nnk.out_order(1738) == (16, 0, 0)
    assert nnk.out_order(34848) == (16, 0, 0)
    assert nnk.out_order(34859) == (2, 0, 0)
    assert nnk.dense_units(env_nn) == 1024 and nnk.dense_units(sel_nn) == 320
    assert sqp_debug.KERNEL_WRAPPERS["K7"] is nnk.forward_jacobian
    bad = cnn.CollisionMLP([np.zeros((8, 21)), np.zeros((1, 8))],
                           [np.zeros(8), np.zeros(1)], device="cpu")
    with pytest.raises(NotImplementedError, match="no kernel instantiation"):
        nnk.net_id(bad)


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: lanes: the three cells' batches, the chip checks' 1,024 and 512, batch 1
CARD_BATCHES = {PANDA.name: (32768, 4096, 1024, 512, 1),
                HUSKY_PANDA.name: (16384, 512, 1)}


def gap(got, ref) -> float:
    """The largest |got - ref| over ref's largest finite magnitude."""
    fin = ~torch.isnan(ref)
    d = (got[fin].double() - ref[fin].double()).abs()
    return float(d.max() / (ref[fin].double().abs().max() + 1e-300))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_k7_matches_plain_lane_by_lane(card, system, dtype):
    sel_nn, env_nn = nets(dtype, card)
    for b in CARD_BATCHES[system.name]:
        qs = knots(system, b, sigma=0.01, seed=b, dtype=dtype, device=card)
        if b > 1:
            qs[b // 2, 4, system.base_dof + 1] = float("nan")
        obs = obstacles(b, dtype, card)
        exact = dtype == torch.float32 and b * 11 >= 5632
        tol = 2e-6 if dtype == torch.float32 else 1e-14
        before = nnk.forward_jacobian.launches
        for args in calls(system, qs, obs, sel_nn, env_nn):
            net, q, off, o, div, cols, offset = args
            got = nnk.forward_jacobian(net, q, off, o, div, cols=cols,
                                       offset=offset, count=True)
            ref = nnk.forward_jacobian_plain(net, q, off, o, div, cols=cols,
                                             offset=offset, count=True)
            torch.cuda.synchronize()
            assert torch.equal(got[2], ref[2])
            for g, r in zip(got[:2], ref[:2]):
                assert torch.equal(torch.isnan(g), torch.isnan(r))
                assert _equal(g, r) if exact else gap(g, r) <= tol, (
                    b, dtype, gap(g, r))
        assert nnk.forward_jacobian.launches == before + 2


@pytest.mark.card
def test_obstacle_of_any_layout(card):
    """RobotData's callers may pass the obstacles as a broadcast view: K7
    gives the same bits as from contiguous rows, and the plain route's."""
    sel_nn, env_nn = nets(torch.float32, card)
    qs = knots(PANDA, 512, sigma=0.01, dtype=torch.float32, device=card)
    view = torch.tensor([[3.0, 3.0, 3.0]], device=card).expand(512, 3)
    got = rd._nn_half(qs, view, sel_nn, env_nn, PANDA)
    ref = rd._nn_half(qs, view.contiguous(), sel_nn, env_nn, PANDA,
                      interpret=True)
    assert all(_equal(a, b) for a, b in zip(got, ref))


@pytest.mark.card
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_one_launch_a_network_a_tick_and_no_sync_in_nn(card, system):
    """Three RTI ticks at 512 lanes: two K7 launches a tick, and with
    ``set_sync_debug_mode("error")`` around every ``robot_data.nn`` span no
    host sync inside one; ``ipm_interpret=True`` launches none."""
    dt, b = torch.float32, 512
    track, params, sel, env = build_problem(dt, card, system=system)
    home = X0_HOME_MOBILE if system.base_dof else X0_HOME
    x0 = torch.tensor(np.tile(home, (b, 1)), dtype=dt, device=card)
    u0 = torch.zeros(b, system.nu, dtype=dt, device=card)
    obs = obstacles(b, dt, card)
    rad = torch.full((b,), 0.05, dtype=dt, device=card)

    class StrictTimer(sqp_debug.PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name):
            with super().phase(name):
                if name != "robot_data.nn":
                    yield
                    return
                torch.cuda.set_sync_debug_mode("error")
                try:
                    yield
                finally:
                    torch.cuda.set_sync_debug_mode("default")

    def ticks(cfg, timer=None):
        carry, x, u = init_carry(b, dt, card, system), x0, u0
        for _ in range(3):
            carry, out = mpc_step(track, params, sel, env, carry, x, u, obs,
                                  rad, cfg=cfg, system=system, timer=timer)
            u, x = out.u0, out.x0_updated
        torch.cuda.synchronize()

    ticks(SQPConfig())   # warm-up: the library and the packs
    before = nnk.forward_jacobian.launches
    ticks(SQPConfig(), StrictTimer(card))
    assert nnk.forward_jacobian.launches == before + 6
    ticks(SQPConfig(ipm_interpret=True))
    assert nnk.forward_jacobian.launches == before + 6


@pytest.mark.card
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_no_cublas_product_in_the_networks(card, system):
    """The NN half on the bench route launches K7 twice and no cuBLAS
    product for the networks: none on the Panda, and on the Husky+Panda
    only the base-frame transform's and the chain rule's three batched
    3 x 3 products."""
    from torch.profiler import ProfilerActivity, profile
    dt = torch.float32
    sel_nn, env_nn = nets(dt, card)
    qs = knots(system, 4096, sigma=0.01, dtype=dt, device=card)
    obs = obstacles(4096, dt, card)
    rd._nn_half(qs, obs, sel_nn, env_nn, system)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rd._nn_half(qs, obs, sel_nn, env_nn, system)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"]
    products = [n for n in names if any(t in n.lower() for t in
                                        ("gemm", "gemv", "cutlass"))]
    assert sum("nn_kernel" in n for n in names) == 2, names
    assert len(products) <= (0 if system.base_dof == 0 else 3), products
