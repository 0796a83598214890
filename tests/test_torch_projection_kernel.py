"""K6 (`ops/projection_kernel.py`): the tick's projection in one launch.

On the CPU: the crafted lanes below take every branch of the projection
(the plain Newton, the masked waypoint fallback, no waypoint in reach, a
tie between waypoints, the track's end, no step converging, the clamps at
0 and at the length); the wrapper's route is the plain version for CPU
tensors and for ``interpret=True``, and ``interpret=False`` raises there;
``mpc_step``'s ticks equal, bit for bit, those of the step-1 code the
kernel replaced.

On the card (marker ``card``; skipped without one): K6 against its plain
version lane by lane on the crafted lanes, for both systems in float32 and
float64; one launch a tick and no host sync inside the ``projection``
span.  There the conftest's JAX import is not wanted, so run them with

    python -m pytest tests/test_torch_projection_kernel.py \
        tests/test_torch_tracing.py -m card --noconftest -q

Tolerances (card): the Panda in float32 bit for bit (K6 rounds each
operation as the plain route's PyTorch ops and cuBLAS products do on an
H100).  Elsewhere -- the Husky+Panda's world-frame Jacobian, float64's
products -- cuBLAS may round a product otherwise, so: the same jump test
on every lane, s within the Newton step's own tolerance, 1e-5, on every
lane and within 1e-6 at the median in float32 (1e-12 in float64), and vs
within 1e-5 of the scale of its terms (|dq_j Jv_j| . |t| summed), since vs
is a sum that can cancel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu_torch import mpc as mpc_mod
from mpcc_manipulator_tpu_torch.models import kinematics as kin
from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kinm
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.ops import cuda_build
from mpcc_manipulator_tpu_torch.ops import projection_kernel as pk
from mpcc_manipulator_tpu_torch.params import SQPConfig
from mpcc_manipulator_tpu_torch.problem import (X0_HOME, X0_HOME_MOBILE,
                                                build_problem)
from mpcc_manipulator_tpu_torch.solver import sqp_debug
from mpcc_manipulator_tpu_torch.splines import arc_length as als
from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA, PANDA
from mpcc_manipulator_tpu_torch.utils.tree import tree_map
from test_torch_tracing import fake_card

torch.set_num_threads(1)

SYSTEMS = [PANDA, HUSKY_PANDA]
LANES = 512


def crafted_lanes(system, track, n: int = LANES, seed: int = 1,
                  dtype=torch.float64, device="cpu"):
    """``(x0, u0)``: the system's home with joints perturbed at four scales
    (0.01 to 1.5 rad), s drawn over the track and 0.3 past either end,
    inputs N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    home = X0_HOME_MOBILE if system.base_dof else X0_HOME
    x = np.tile(home, (n, 1))
    scale = rng.choice([0.01, 0.1, 0.5, 1.5], size=n)
    x[:, :system.dof] += scale[:, None] * rng.standard_normal((n,
                                                               system.dof))
    length = float(track.length)
    x[:, system.s_idx] = rng.uniform(-0.3, length + 0.3, n)
    u = 0.3 * rng.standard_normal((n, system.nu))
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(u, dtype=dtype, device=device))


def tie_track(track):
    """The track with every odd waypoint a copy of the even one before it,
    so that a lane's nearest waypoints tie."""
    wp = track.wp.clone()
    wp[1::2] = wp[0::2]
    return dataclasses.replace(track, wp=wp)


def branches(track, x0, max_dist_proj, system) -> dict:
    """Which branch of `arc_length.project_on_spline` each lane takes, from
    the plain route's own steps: name -> (B,) bool."""
    q = x0[:, :system.dof]
    ee = kin.fk_chain(q)[0] if system.base_dof == 0 else kinm.ee_position(q)
    s_guess = x0[:, system.s_idx]
    dist0 = torch.linalg.vector_norm(ee - als.track_position(track, s_guess),
                                     dim=-1)
    d2 = ((track.wp[None] - ee[:, None, :]) ** 2).sum(-1)
    valid = (track.s_knots[None] - s_guess[:, None]).abs() <= max_dist_proj
    masked = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    far, reach = dist0 >= max_dist_proj, valid.any(-1)
    chosen = torch.where(reach[:, None], masked, d2)
    best = torch.where(reach, masked.argmin(-1), d2.argmin(-1))
    s0 = torch.where(far, track.s_knots[best], s_guess)
    at_end = s0 >= track.length
    s_cur, conv = s0, torch.zeros_like(at_end)
    low, high = torch.zeros_like(at_end), torch.zeros_like(at_end)
    for _ in range(20):
        p = als.track_position(track, s_cur)
        dp = als.track_derivative(track, s_cur)
        ddp = als.track_second_derivative(track, s_cur)
        diff = p - ee
        raw = s_cur - ((diff * dp).sum(-1)
                       / ((dp * dp).sum(-1) + (diff * ddp).sum(-1)))
        low |= ~conv & (raw < 0)
        high |= ~conv & (raw > track.length)
        s_new = torch.minimum(raw.clamp(min=0.0), track.length)
        conv = conv | ((s_cur - s_new).abs() <= 1e-5)
        s_cur = torch.where(conv, s_cur, s_new)
    live = ~at_end
    n_min = (chosen == chosen.min(-1, keepdim=True).values).sum(-1)
    return dict(near=live & ~far, masked=far & reach, global_=far & ~reach,
                tie=far & (n_min > 1), at_end=at_end, no_conv=live & ~conv,
                clamp0=live & low, clamp_len=live & high)


def cases(system, dtype, device="cpu"):
    """The crafted lanes on the main track and on :func:`tie_track`:
    ``[(track, x0, u0, max_dist_proj)]``."""
    track, params, _, _ = build_problem(dtype, device, system=system)
    x0, u0 = crafted_lanes(system, track, dtype=dtype, device=device)
    mdp = params.model.max_dist_proj
    return [(track, x0, u0, mdp), (tie_track(track), x0, u0, mdp)]


def _parent_step1(track, x0, u0, max_dist_proj, system, interpret=None):
    """Step 1 of `mpc_step` as it stood before K6, verbatim."""
    dof = system.dof
    q = x0[:, :dof]
    dq = u0[:, :dof]
    last_s = x0[:, system.s_idx]
    if system.base_dof == 0:
        p_ee, _, origins, axes = kin.fk_chain(q)
        jv = torch.linalg.cross(axes, p_ee[:, None, :] - origins)
    else:
        p_ee = kinm.ee_position(q)
        jv = kinm.ee_jacobian(q)[:, :3].transpose(-1, -2)  # B,10,3
    s_proj = als.project_on_spline(track, last_s, p_ee, max_dist_proj)
    vs = ((dq[:, :, None] * jv).sum(1)
          * als.track_derivative(track, s_proj)).sum(-1)
    x0_new = x0.clone()
    x0_new[:, system.s_idx] = s_proj
    x0_new[:, system.vs_idx] = vs
    return x0_new, s_proj


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_crafted_lanes_take_every_branch(system):
    """Every branch of the projection is taken by some crafted lane, the
    tie on the tie track (float64, the plain route's own steps)."""
    (track, x0, u0, mdp), (ttrack, *_) = cases(system, torch.float64)
    seen = branches(track, x0, mdp, system)
    tied = branches(ttrack, x0, mdp, system)
    counts = {k: int(v.sum()) for k, v in seen.items()}
    counts["tie"] = int(tied["tie"].sum())
    assert all(counts[k] > 0 for k in counts), counts
    assert not seen["tie"].any()   # a real track's waypoints do not tie


@pytest.mark.parametrize("flag", [None, True])
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_route_is_plain_on_the_cpu(system, flag):
    """On CPU tensors ``interpret=None`` and ``True`` run the plain version
    bit for bit, which is the step-1 code it replaced; no launch counts."""
    before = cuda_build.LAUNCHES["K6"]
    for track, x0, u0, mdp in cases(system, torch.float64):
        got = pk.project_and_vs(track, x0, u0, mdp, system, interpret=flag)
        ref = _parent_step1(track, x0, u0, mdp, system)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert cuda_build.LAUNCHES["K6"] == before


@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_interpret_false_raises_on_the_cpu(system):
    (track, x0, u0, mdp), _ = cases(system, torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        pk.project_and_vs(track, x0, u0, mdp, system, interpret=False)


RICCATI = SQPConfig()
ADMM = SQPConfig(qp_solver="admm", qp_backend="pallas", qp_assembly="xla")


@pytest.mark.parametrize("system,cfg", [(PANDA, RICCATI), (PANDA, ADMM),
                                        (HUSKY_PANDA, RICCATI)],
                         ids=["panda-riccati", "panda-admm",
                              "husky_panda-riccati"])
def test_mpc_step_unchanged_on_the_cpu(monkeypatch, system, cfg):
    """Three ticks of ``mpc_step`` (4 lanes from home + 0.01 N(0, 1), a
    stand-in plant between) equal, bit for bit in every field, the same
    ticks with step 1 as it stood before K6 (the dense ADMM path is
    Panda-only, as in JAX)."""
    dt, b = torch.float64, 4
    track, params, sel, env = build_problem(dt, "cpu", system=system)
    home = X0_HOME_MOBILE if system.base_dof else X0_HOME
    gen = torch.Generator().manual_seed(5)
    x0 = (torch.tensor(np.tile(home, (b, 1)), dtype=dt)
          + 0.01 * torch.randn(b, system.nx, generator=gen, dtype=dt))
    obs = torch.full((b, 3), 3.0, dtype=dt)
    rad = torch.zeros(b, dtype=dt)

    def run():
        carry, x = init_carry(b, dt, "cpu", system), x0
        u = torch.zeros(b, system.nu, dtype=dt)
        outs = []
        for _ in range(3):
            carry, out = mpc_step(track, params, sel, env, carry, x, u, obs,
                                  rad, cfg=cfg, system=system)
            u = out.u0
            x = out.x0_updated + 0.01 * torch.cat(
                [u, torch.zeros(b, 1, dtype=dt)], dim=-1)
            outs.append((carry, out))
        return outs

    now = run()
    monkeypatch.setattr(mpc_mod.projection_kernel, "project_and_vs",
                        _parent_step1)
    before = run()
    for (c1, o1), (c0, o0) in zip(now, before):
        assert _same(c1, c0) and _same(o1, o0)


def test_tables_and_shared_memory(monkeypatch):
    """The 22 tables in the C entry's order; the shared bytes a block
    (K4's 96 constants and 16 values a knot) within the kernel's 48 KB at
    the track's 100 knots in either dtype; on the kernel route (a stand-in
    library, `test_torch_tracing.fake_card`) a call is one launch of
    `mpcc_project_vs`, counted as K6's."""
    track, params, _, _ = build_problem(torch.float64, "cpu")
    tabs = pk.tables(track, params.model.max_dist_proj)
    assert len(tabs) == 22
    assert tabs[0] is track.sx.a and tabs[11] is track.sz.d
    assert tabs[12] is track.wp and tabs[13] is track.s_knots
    assert tabs[14] is track.sx.delta and tabs[19] is track.sz.length
    assert tabs[20] is track.length
    assert tabs[21] is params.model.max_dist_proj
    assert pk.shared_bytes(100, torch.float32) == 4 * (96 + 1600)
    assert pk.shared_bytes(100, torch.float64) <= pk.SHARED_LIMIT
    lib = fake_card(monkeypatch)
    meta = lambda t: (t.to("meta", torch.float32)
                      if isinstance(t, torch.Tensor) else t)
    pk.project_and_vs(tree_map(meta, track), torch.zeros(3, 9, device="meta"),
                      torch.zeros(3, 8, device="meta"),
                      meta(params.model.max_dist_proj))
    assert [e for e, _ in lib.calls] == ["mpcc_project_vs"]
    assert cuda_build.LAUNCHES["K6"] == sum(cuda_build.LAUNCHES.values()) == 1


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 runs only on the card")
    return torch.device("cuda", 0)


def agreement(got, ref, x0, u0, track, mdp, system) -> dict:
    """K6's outputs against the plain version's from the same inputs:
    ``jumped`` mismatches, |ds| (largest, median), vs's gap over the scale
    of its terms, the other columns' equality and the bit-identical
    share of s."""
    (x_k, s_k), (x_p, s_p) = got, ref
    last_s = x0[:, system.s_idx]
    jumped = [(last_s - s).abs() > mdp for s in (s_k, s_p)]
    ds = (s_k - s_p).abs().double()
    dq = u0[:, :system.dof].double()
    q = x0[:, :system.dof].double().cpu()
    jv = (kin.ee_jacobian(q) if system.base_dof == 0
          else kinm.ee_jacobian(q))[:, :3].to(dq.device)
    tan = als.track_derivative(track, s_p).double().abs()
    scale = ((dq[:, None, :] * jv).abs().sum(-1) * tan).sum(-1) + 1e-30
    dvs = ((x_k[:, system.vs_idx] - x_p[:, system.vs_idx]).double().abs()
           / scale)
    dof = system.dof
    return dict(jumped=int((jumped[0] != jumped[1]).sum()),
                ds_max=float(ds.max()), ds_median=float(ds.median()),
                dvs_max=float(dvs.max()),
                s_equal=float((s_k == s_p).double().mean()),
                rest_equal=bool(torch.equal(x_k[:, :dof], x0[:, :dof])
                                and torch.equal(x_k[:, system.s_idx], s_k)))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_k6_matches_plain_lane_by_lane(card, system, dtype):
    median_tol = 1e-6 if dtype == torch.float32 else 1e-12
    exact = system.base_dof == 0 and dtype == torch.float32
    before = cuda_build.LAUNCHES["K6"]
    for track, x0, u0, mdp in cases(system, dtype, card):
        got = pk.project_and_vs(track, x0, u0, mdp, system)
        ref = pk.project_and_vs_plain(track, x0, u0, mdp, system)
        torch.cuda.synchronize()
        assert not exact or all(torch.equal(a, b) for a, b in zip(got, ref))
        gap = agreement(got, ref, x0, u0, track, mdp, system)
        assert gap["jumped"] == 0 and gap["rest_equal"], gap
        assert gap["ds_max"] <= 1e-5 and gap["ds_median"] <= median_tol, gap
        assert gap["dvs_max"] <= 1e-5, gap
    assert cuda_build.LAUNCHES["K6"] == before + 2


@pytest.mark.card
@pytest.mark.parametrize("system", SYSTEMS, ids=lambda s: s.name)
def test_one_launch_a_tick_and_no_sync_in_projection(card, system):
    """Three RTI ticks at 256 lanes: one K6 launch a tick, and with
    ``set_sync_debug_mode("error")`` around every ``projection`` span no
    host sync inside one; ``ipm_interpret=True`` launches none."""
    dt, b = torch.float32, 256
    track, params, sel, env = build_problem(dt, card, system=system)
    x0, u0 = crafted_lanes(system, track, n=b, dtype=dt, device=card)
    x0[:, system.s_idx] = 0.0
    u0.zero_()
    obs = torch.full((b, 3), 3.0, dtype=dt, device=card)
    rad = torch.zeros(b, dtype=dt, device=card)

    class StrictTimer(sqp_debug.PhaseTimer):
        def phase(self, name):
            span = super().phase(name)
            if name != "projection":
                return span
            return _strict(span)

    def ticks(cfg, timer=None):
        carry, x, u = init_carry(b, dt, card, system), x0, u0
        for _ in range(3):
            carry, out = mpc_step(track, params, sel, env, carry, x, u, obs,
                                  rad, cfg=cfg, system=system, timer=timer)
            u, x = out.u0, out.x0_updated
        torch.cuda.synchronize()

    ticks(SQPConfig())   # warm-up: the library and the constants
    before = cuda_build.LAUNCHES["K6"]
    ticks(SQPConfig(), StrictTimer(card))
    assert cuda_build.LAUNCHES["K6"] == before + 3
    ticks(SQPConfig(ipm_interpret=True))
    assert cuda_build.LAUNCHES["K6"] == before + 3


class _strict:
    """A span with ``set_sync_debug_mode("error")`` inside it."""

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        self.span.__enter__()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return self.span.__exit__(*exc)
