"""The JAX package's closed-loop gates as scenario runners for the port.

Each gate is one function that builds its problem, drives the closed loop
through :func:`..mpc.mpc_step` (or :func:`..sim.closed_loop_scan`) for a
batch of lanes, checks the JAX test's contract with the JAX test's own
thresholds on every lane, and returns its figures (worst margin, worst CBF
residual, ticks, wall seconds).  A broken contract raises
``AssertionError``.  The CPU tests run them in float64 on one lane (the
plain versions); ``chip_smoke.py`` and :func:`main` run them in float32 on
the card (K1-K4) on 8 lanes: the exact home state and 7 lanes with
1e-3 N(0, 1) on the joints.

| gate | JAX test |
| --- | --- |
| :func:`track_completion` | `tests/test_track_completion.py:71`, `:85` |
| :func:`static_obstacle` | `tests/test_obstacle_avoidance.py:139` |
| :func:`detour_obstacle` | `:171` |
| :func:`oscillating_obstacle` | `:210` |
| :func:`rti_obstacle` | `tests/test_rti.py:109` |
| :func:`rti_vs_converged` | `tests/test_rti.py:36` |
| :func:`rti_vs_converged_jax_route` | the same on JAX's settings (float64) |
| :func:`config_ladder` | `tests/test_config_ladder.py:58-90` |
| :func:`letter_completion` | `tests/test_letter_track.py:27` (matplotlib) |

The env-collision contract (`test_obstacle_avoidance.py`): the RBF rows
are discrete control barrier functions, so per tick the robot may never
decrease any link's barrier ``h = (d - 1.2 r - tol_env) / 100`` faster than
``ts * RBF(h)``.  The residual ``h(x_{t+1}, o_t) - h(x_t, o_t) - ts RBF(h(x_t,
o_t))``, minimized over links, must stay above ``-CBF_EPS_CM`` (in cm of h)
after the first 5 ticks.

    python -m mpcc_manipulator_tpu_torch.gates [--only NAME ...]
        [--device cuda|cpu] [--float64] [--lanes 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import timing
from .models import collision_nn as cnn
from .models import dynamics as dyn
from .models import kinematics as kin
from .mpc import _cold_start, _unwrap_s, init_carry, mpc_step
from .ocp.constraints import rbf
from .ocp.qp_data import split_z
from .ops.assembly_kernel import eval_point_kernel, eval_point_plain
from .ocp.robot_data import compute_robot_data
from .params import SQPConfig, load_params
from .problem import X0_HOME, build_problem
from .sim import closed_loop_scan
from .solver.sqp import Status
from .splines import arc_length as als

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK_JSON = os.path.join(_REPO_ROOT, "assets", "tracks", "track.json")

TS = 0.01
# the JAX gates' solver settings on the port's structured route (JAX's
# qp_solver="riccati" is the packed solver, not ported; riccati_struct is
# the same algorithm as the port's structured IPM)
CONVERGED = SQPConfig(rti=False, max_iter=20, ipm_max_iter=25)
RTI = SQPConfig(max_iter=1, rti=True, ipm_max_iter=25)
TOL_ENV = 8.0     # cm (assets/params/model.json: tol_envcol)
TOL_SEL = 1.0     # cm (tol_selcol)
OBS_R = 3.0       # cm
MARGIN = TOL_ENV + 1.2 * OBS_R   # cm, the constraint's own margin
EPS_CM = 1.0      # soft-constraint slack below the margin
CBF_EPS_CM = 0.05  # per-tick CBF residual floor, cm of h
CBF_WARMUP = 5
CHUNK = 250       # closed_loop_scan ticks per chunk
N_SIM = 10000     # the reference's tick budget (`config.json:3`)
LANE_SIGMA = 1e-3
# RTI against the converged mode (`test_rti.py:36`): q and s within 1e-4.
AB_TOL = 1e-4
# the JAX gates' own settings besides the solver (`test_rti.py:23-24`):
# JAX's defaults, a cold interior point, the finite-difference gradient on
# the plain kinematics, the plain assembly (on the card: K1 alone)
JAX_ROUTE = dict(ipm_warm_start=False, mani_grad="fd", kin_backend="xla",
                 qp_assembly="xla")
# JAX's float32 kernel route (riccati_pallas in interpret mode on
# JAX_ROUTE, as `test_track_completion.py:85` runs it) misses AB_TOL on
# these 8 starts, at max |dq| 3.1986e-4
# (`tests/test_torch_gates.py::test_rti_vs_converged_float32_figure_of_jax`)
AB_JAX_F32_FIGURE = 3.2e-4
# an l1 violation below this many eps of the dtype is rounding (the
# equality rows hold exactly after a Riccati step in exact arithmetic)
VIO_ROUNDOFF = 100
LANES = 8         # the card's lanes: home, then 7 perturbed


def _check(cond, *what) -> None:
    """A gate's contract: raise (also under ``python -O``) when it fails."""
    if not cond:
        raise AssertionError(what)


def home_states(lanes: int, dtype, device, seed: int = 0) -> torch.Tensor:
    """(lanes, 9): the exact home state, then lanes with 1e-3 N(0, 1) on
    the seven joints."""
    x = np.tile(X0_HOME, (lanes, 1))
    x[1:, :7] += LANE_SIGMA * np.random.default_rng(seed).standard_normal(
        (lanes - 1, 7))
    return torch.tensor(x, dtype=dtype, device=device)


def nets(dtype, device):
    return (cnn.load_self_collision_nn(dtype, device),
            cnn.load_env_collision_nn(dtype, device))


def circle_track(dtype, device):
    """The obstacle and ladder tests' track: a 0.12 m circle in the y-z
    plane from the home pose's EE position, at its orientation."""
    q0 = torch.tensor(X0_HOME[:7], dtype=torch.float64)
    ee = kin.ee_position(q0).numpy()
    rot = kin.ee_orientation(q0).numpy()
    nt = 80
    phi = np.linspace(0, 2 * np.pi, nt)
    return als.gen_6d_spline(
        np.zeros(nt) + ee[0], 0.12 * np.cos(phi) - 0.12 + ee[1],
        0.12 * np.sin(phi) + ee[2], np.tile(rot, (nt, 1, 1)), dtype, device)


def file_track(path: str, dtype, device):
    """A reference-format track JSON shifted to the home pose's EE."""
    ee = kin.ee_position(torch.tensor(X0_HOME[:7], dtype=torch.float64))
    xw, yw, zw, rots = als.load_track_waypoints(path)
    xw, yw, zw = als.shift_track_to(xw, yw, zw, ee.numpy())
    return als.gen_6d_spline(xw, yw, zw, rots, dtype, device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ completion


def run_to_completion(track, x0: torch.Tensor, cfg: SQPConfig,
                      max_ticks: int) -> dict:
    """Chunked ``closed_loop_scan`` from x0 (B, 9) until every lane has
    finished (the end-point criterion freezes a lane) or ``max_ticks``;
    per lane: finished, ticks to the finish, |s - L|, the EE's distance to
    the track's end, and the smallest share of ok ticks before the finish
    in any chunk."""
    dtype, dev = x0.dtype, x0.device
    params, _ = load_params(dtype=dtype, device=dev)
    sel, env = nets(dtype, dev)
    b = x0.shape[0]
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=dtype, device=dev).expand(b, 3)
    rad = torch.zeros(b, dtype=dtype, device=dev)
    x, ticks = x0, 0
    ok_frac = np.ones(b)
    done_at = np.full(b, -1)
    _sync(dev)
    t0 = time.perf_counter()
    while ticks < max_ticks:
        xs, _, _, ok, fin = closed_loop_scan(
            track, params, sel, env, x, obs, rad, n_steps=CHUNK, ts=TS,
            cfg=cfg)
        fin, ok = _np(fin), _np(ok)
        active = ~np.concatenate([np.zeros((b, 1), bool), fin[:, :-1]], 1)
        for i in range(b):
            if active[i].any():
                ok_frac[i] = min(ok_frac[i], float(ok[i, active[i]].mean()))
            if done_at[i] < 0 and fin[i].any():
                done_at[i] = ticks + int(np.argmax(fin[i])) + 1
        ticks += CHUNK
        x = xs[:, -1]
        if fin[:, -1].all():
            break
    _sync(dev)
    secs = time.perf_counter() - t0
    length = float(track.length)
    ee = _np(kin.ee_position(x[:, :7]))
    end = _np(als.track_position(track, track.length))
    return dict(finished=fin[:, -1], ticks=ticks, done_at=done_at,
                s_err=np.abs(_np(x[:, 7]) - length),
                ee_err=np.linalg.norm(ee - end, axis=-1), ok_frac=ok_frac,
                length=length, seconds=secs)


def _completion_contract(name: str, r: dict, max_ticks: int) -> dict:
    _check(r["finished"].all(), (name, "not finished", r["ticks"],
                                 r["s_err"], r["ee_err"]))
    _check(r["ticks"] <= max_ticks, (name, r["ticks"]))
    _check((r["s_err"] < 1e-2).all(), (name, "|s - L|", r["s_err"]))
    _check((r["ee_err"] < 1e-2).all(), (name, "EE error", r["ee_err"]))
    _check((r["ok_frac"] == 1.0).all(), (name, "not-ok ticks", r["ok_frac"]))
    return dict(gate=name, lanes=len(r["done_at"]),
                ticks_to_finish=[int(v) for v in r["done_at"]],
                worst_s_err=float(r["s_err"].max()),
                worst_ee_err=float(r["ee_err"].max()),
                length=r["length"], seconds=r["seconds"])


def track_completion(dtype=torch.float32, device="cuda", lanes: int = LANES,
                     max_ticks: int = 3000) -> dict:
    """`test_track_completion.py`: the repo's track to the end point
    (|s - L| < 1e-2, EE < 1e-2, every tick before the finish ok) in the
    converged mode; JAX's budget is 3,000 ticks in float32 and the
    reference's 10,000 in float64."""
    track = file_track(TRACK_JSON, dtype, device)
    r = run_to_completion(track, home_states(lanes, dtype, device),
                          CONVERGED, max_ticks)
    return _completion_contract("track", r, max_ticks)


def letter_completion(dtype=torch.float64, device="cuda", lanes: int = 1,
                      max_ticks: int = 25000) -> dict:
    """`test_letter_track.py`: "DYROS" (height 0.10 m, 300 points) through
    a written and reloaded JSON, to the end point (matplotlib's font
    data)."""
    import tempfile

    from .runtime.track_gen import letter_track, write_track
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dyros.json")
        write_track(path, letter_track("DYROS", height=0.10, n_points=300))
        track = file_track(path, dtype, device)
    r = run_to_completion(track, home_states(lanes, dtype, device),
                          CONVERGED, max_ticks)
    _check(r["finished"].all(), ("letter", r["ticks"], r["s_err"]))
    _check((r["ee_err"] < 1e-2).all() and (r["s_err"] < 1e-2).all(), r)
    return dict(gate="letter", lanes=lanes,
                ticks_to_finish=[int(v) for v in r["done_at"]],
                worst_s_err=float(r["s_err"].max()),
                worst_ee_err=float(r["ee_err"].max()),
                length=r["length"], seconds=r["seconds"])


# ------------------------------------------------------------ obstacles


def h_dists(q: torch.Tensor, obs: torch.Tensor, r: torch.Tensor,
            tol_env: float, sel_nn, env_nn):
    """Per-link barrier h (m, the constraint's units) (B, links), the
    smallest env distance (B,) and the self distance (B,) [cm], from
    ``compute_robot_data`` on the plain route (JAX `_h_dists`)."""
    rb = compute_robot_data(q[:, None, :], obs, r, sel_nn, env_nn,
                            mani_grad="ad", kin_backend="xla")
    env = rb.env_dist[:, 0]
    h = 0.01 * (env - 1.2 * r[:, None]) - 0.01 * tol_env
    return h, env.min(dim=-1).values, rb.sel_dist[:, 0]


def run_logged(track, x0: torch.Tensor, overrides: dict, n_steps: int,
               obs_path, obs_r: float, tol_env: float = TOL_ENV,
               cfg: SQPConfig = CONVERGED) -> dict:
    """Closed loop from x0 (B, 9) with per-tick (B, T) logs: min env
    distance, self distance, s, the CBF residual and ok (JAX
    `_run_logged`).  ``obs_path(t)`` is the obstacle's position at tick t,
    fed to the solver that tick; the residual holds it fixed across the
    tick."""
    dtype, dev = x0.dtype, x0.device
    sel_nn, env_nn = nets(dtype, dev)
    params, _ = load_params(overrides=overrides, dtype=dtype, device=dev)
    b = x0.shape[0]
    carry = init_carry(b, dtype, dev)
    x, u = x0, torch.zeros(b, 8, dtype=dtype, device=dev)
    r = torch.full((b,), obs_r, dtype=dtype, device=dev)
    logs = {k: [] for k in ("env_min", "sel_min", "s", "cbf", "ok")}
    prev = None
    for t in range(n_steps):
        o = np.asarray(obs_path(t), dtype=np.float64)
        obs = torch.tensor(o, dtype=dtype, device=dev).expand(b, 3)
        if prev is not None and np.array_equal(prev[0], o):
            h_pre = prev[1]          # same obstacle: last tick's h_post
        else:
            h_pre = h_dists(x[:, :7], obs, r, tol_env, sel_nn, env_nn)[0]
        carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x, u,
                              obs, r, ts=TS, cfg=cfg)
        u = out.u0
        x = dyn.sim_time_step(out.x0_updated, u, TS)
        h_post, e, s = h_dists(x[:, :7], obs, r, tol_env, sel_nn, env_nn)
        prev = (o, h_post)
        logs["env_min"].append(e)
        logs["sel_min"].append(s)
        logs["s"].append(x[:, 7])
        logs["cbf"].append((h_post - h_pre - TS * rbf(h_pre)).min(dim=-1)
                           .values)
        logs["ok"].append(out.ok)
    return {k: _np(torch.stack(v, dim=1)) for k, v in logs.items()}


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _worst_cbf_cm(cbf: np.ndarray) -> float:
    return float(100.0 * cbf[:, CBF_WARMUP:].min())


def _obstacle_contract(name: str, lg: dict, margin: float) -> dict:
    _check(lg["ok"].all(), (name, "not-ok ticks",
                            np.argwhere(~lg["ok"])[:5].tolist()))
    worst = _worst_cbf_cm(lg["cbf"])
    _check(lg["env_min"].min() >= margin - EPS_CM, (
        name, "margin", float(lg["env_min"].min()), margin))
    _check(worst >= -CBF_EPS_CM, (name, "CBF rate bound violated", worst))
    _check(lg["sel_min"].min() >= TOL_SEL, (name, "self distance",
                                            float(lg["sel_min"].min())))
    return dict(worst_env_min_cm=float(lg["env_min"].min()),
                margin_cm=margin, worst_cbf_cm=worst,
                worst_sel_min_cm=float(lg["sel_min"].min()))


def _blocking_obstacle(track) -> tuple:
    """The static gates' sphere: 6 cm out of the track plane at s = L/2."""
    s_obs = 0.5 * float(track.length)
    obs = (_np(als.track_position(track, track.length * 0.5))
           + np.asarray([0.06, 0.0, 0.0]))
    return s_obs, obs


def static_obstacle(dtype=torch.float32, device="cuda",
                    lanes: int = LANES, n: int = 300,
                    disabled: bool = True) -> dict:
    """`test_obstacle_avoidance.py:139`: a static sphere blocking the path;
    constrained, the robot advances past 0.2 L, stops short of the sphere
    and holds the margin and the CBF contract; with the constraint
    disabled (a second ``n``-tick run, left out when ``disabled`` is
    false) it drives through (s past the sphere, the margin broken by more
    than 3 cm)."""
    track = circle_track(dtype, device)
    L = float(track.length)
    s_obs, obs = _blocking_obstacle(track)
    x0 = home_states(lanes, dtype, device)
    lg, secs = _timed(lambda: run_logged(
        track, x0, {"param": {"desired_ee_velocity": 0.25}}, n,
        lambda t: obs, OBS_R))
    out = _obstacle_contract("static", lg, MARGIN)
    s_end = lg["s"][:, -1]
    _check((s_end > 0.2 * L).all(), ("static", "progress", s_end))
    _check((s_end < s_obs).all(), ("static", "passed the sphere", s_end))
    res = dict(gate="static", lanes=lanes, ticks=n, **out,
               s_end=[float(v) for v in s_end], s_obs=s_obs, seconds=secs)
    if not disabled:
        return res
    off, secs_off = _timed(lambda: run_logged(
        track, x0, {"param": {"desired_ee_velocity": 0.25,
                              "tol_envcol": -1e3}}, n, lambda t: obs, OBS_R))
    _check(off["ok"].all(), ("static (disabled)", "not-ok ticks"))
    _check((off["s"][:, -1] > s_obs + 0.02).all(), (
        "static (disabled)", off["s"][:, -1], s_obs))
    _check(off["env_min"].min(axis=1).max() < MARGIN - 3.0, (
        "static (disabled)", off["env_min"].min(axis=1)))
    return dict(res, disabled_env_min_cm=float(off["env_min"].min(axis=1)
                                               .max()),
                disabled_worst_cbf_cm=_worst_cbf_cm(off["cbf"]),
                seconds=secs + secs_off)


def detour_obstacle(dtype=torch.float32, device="cuda", lanes: int = LANES,
                    n: int = 900, n_off: int = 400) -> dict:
    """`test_obstacle_avoidance.py:171`: a 2 cm sphere 8 cm out of plane,
    margin 6.4 cm (tol_envcol 4): the margin held on every tick with the
    constraint active (the closest approach within 1 cm of it) while s
    passes the sphere; disabled, the margin breaks by more than 1.5 cm and
    the residual falls below the bound."""
    track = circle_track(dtype, device)
    s_obs = 0.5 * float(track.length)
    obs_r, tol_env = 2.0, 4.0
    margin = tol_env + 1.2 * obs_r
    obs = (_np(als.track_position(track, track.length * 0.5))
           + np.asarray([0.08, 0.0, 0.0]))
    x0 = home_states(lanes, dtype, device)
    lg, secs = _timed(lambda: run_logged(
        track, x0, {"param": {"desired_ee_velocity": 0.4,
                              "tol_envcol": tol_env}},
        n, lambda t: obs, obs_r, tol_env=tol_env))
    out = _obstacle_contract("detour", lg, margin)
    _check((lg["env_min"].min(axis=1) <= margin + 1.0).all(), (
        "detour", "constraint never active", lg["env_min"].min(axis=1)))
    _check((lg["s"][:, -1] > s_obs + 0.02).all(), ("detour", lg["s"][:, -1]))
    off, secs_off = _timed(lambda: run_logged(
        track, x0, {"param": {"desired_ee_velocity": 0.4,
                              "tol_envcol": -1e3}},
        n_off, lambda t: obs, obs_r, tol_env=tol_env))
    _check(off["ok"].all(), ("detour (disabled)", "not-ok ticks"))
    _check(off["env_min"].min(axis=1).max() < margin - 1.5, (
        "detour (disabled)", off["env_min"].min(axis=1)))
    worst_off = 100.0 * off["cbf"][:, CBF_WARMUP:].min(axis=1)
    _check((worst_off < -CBF_EPS_CM).all(), ("detour (disabled)", worst_off))
    return dict(gate="detour", lanes=lanes, ticks=n, **out,
                s_end=[float(v) for v in lg["s"][:, -1]], s_obs=s_obs,
                disabled_worst_cbf_cm=float(worst_off.max()),
                seconds=secs + secs_off)


def oscillating_obstacle(dtype=torch.float32, device="cuda",
                         lanes: int = LANES, n: int = 1300) -> dict:
    """`test_obstacle_avoidance.py:210`: a 3 cm sphere sweeping out of the
    track plane and back across the crossing point (0.075 m/s, tol_envcol
    4); the robot passes the crossing with the CBF contract held on every
    tick and never touches the sphere."""
    track = circle_track(dtype, device)
    s_obs = 0.5 * float(track.length)
    center = _np(als.track_position(track, track.length * 0.5))
    x_half, step, tol_env = 0.15, 0.075 * TS, 4.0

    def obs_path(t):
        phase = (step * t) % (4 * x_half)
        dz = phase if phase <= 2 * x_half else 4 * x_half - phase
        return center + np.asarray([abs(x_half - dz), 0.0, 0.0])

    lg, secs = _timed(lambda: run_logged(
        track, home_states(lanes, dtype, device),
        {"param": {"desired_ee_velocity": 0.25, "tol_envcol": tol_env}},
        n, obs_path, OBS_R, tol_env=tol_env))
    _check(lg["ok"].all(), ("oscillating", "not-ok ticks"))
    worst = _worst_cbf_cm(lg["cbf"])
    _check(worst >= -CBF_EPS_CM, ("oscillating", "CBF", worst))
    _check(lg["env_min"].min() > OBS_R, ("oscillating", "contact",
                                         float(lg["env_min"].min())))
    _check((lg["s"][:, -1] > s_obs + 0.02).all(), ("oscillating",
                                                   lg["s"][:, -1]))
    _check(lg["sel_min"].min() >= TOL_SEL)
    return dict(gate="oscillating", lanes=lanes, ticks=n,
                worst_env_min_cm=float(lg["env_min"].min()),
                contact_cm=OBS_R, worst_cbf_cm=worst,
                worst_sel_min_cm=float(lg["sel_min"].min()),
                s_end=[float(v) for v in lg["s"][:, -1]], s_obs=s_obs,
                seconds=secs)


def rti_obstacle(dtype=torch.float32, device="cuda", lanes: int = LANES,
                 n: int = 300) -> dict:
    """`test_rti.py:109`: the static blocking sphere under RTI: the margin
    and the CBF contract hold, with progress past 0.2 L before the stop."""
    track = circle_track(dtype, device)
    _, obs = _blocking_obstacle(track)
    lg, secs = _timed(lambda: run_logged(
        track, home_states(lanes, dtype, device),
        {"param": {"desired_ee_velocity": 0.25}}, n, lambda t: obs, OBS_R,
        cfg=RTI))
    out = _obstacle_contract("rti_obstacle", lg, MARGIN)
    _check((lg["s"][:, -1] > 0.2 * float(track.length)).all(), lg["s"][:, -1])
    return dict(gate="rti_obstacle", lanes=lanes, ticks=n, **out,
                s_end=[float(v) for v in lg["s"][:, -1]], seconds=secs)


# ------------------------------------------------------------ nominal loops


def tick0_filter(track, params, sel, env, x0_updated, z_first, z_second,
                 obs, rad, cfg: SQPConfig) -> tuple:
    """The converged mode's filter at tick 0, evaluated from outside: the
    objective and l1 violation (each (B,)) at the first SQP iterate
    ``z_first`` (the RTI run's tick-0 iterate, which the filter entered
    first) and at the converged run's tick-0 iterate ``z_second``, with the
    route's own evaluation on the tick's RobotData (a cold start: every
    knot at ``x0_updated``), so on an accepted second step these are the
    values the filter compared."""
    b = x0_updated.shape[0]
    z0 = _unwrap_s(_cold_start(x0_updated), track.length)
    xs0, _ = split_z(z0)
    rb = compute_robot_data(xs0[..., :7].contiguous(), obs, rad, sel, env,
                            mani_grad=cfg.mani_grad,
                            kin_backend=cfg.kin_backend)
    evaluate = (eval_point_kernel if cfg.qp_assembly == "pallas"
                else eval_point_plain)
    u = torch.zeros(b, 8, dtype=x0_updated.dtype, device=x0_updated.device)
    return (evaluate(track, z_first, rb, params, u, TS),
            evaluate(track, z_second, rb, params, u, TS))


def ab_run(dtype, device, lanes: int, n: int, route: dict) -> dict:
    """60 (``n``) nominal ticks on the bench problem from
    :func:`home_states`, converged and RTI (``route`` replacing their
    fields): both ok every tick, RTI SOLVED in one SQP iteration; the
    per-lane largest |dq| and |ds| between the two runs, and
    :func:`tick0_filter`'s values (``obj_first``, ``obj_second``,
    ``vio_first``, ``vio_second``)."""
    track, params, sel, env = build_problem(dtype, device)
    x0 = home_states(lanes, dtype, device)
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=dtype, device=device).expand(
        lanes, 3)
    rad = torch.zeros(lanes, dtype=dtype, device=device)
    states, tick0 = {}, {}
    t0 = time.perf_counter()
    for name, cfg in (("full", CONVERGED), ("rti", RTI)):
        cfg = dataclasses.replace(cfg, **route)
        carry = init_carry(lanes, dtype, device)
        x, u = x0, torch.zeros(lanes, 8, dtype=dtype, device=device)
        xs = []
        for t in range(n):
            carry, out = mpc_step(track, params, sel, env, carry, x, u, obs,
                                  rad, ts=TS, cfg=cfg)
            _check(bool(out.ok.all()), (name, t, _np(out.status)))
            if name == "rti":
                _check(bool((out.status == Status.SOLVED).all()),
                       (t, "status"))
                _check(bool((out.sqp_iters == 1).all()), (t, "sqp_iters"))
            if t == 0:
                tick0[name] = (out.x0_updated, carry.z_guess)
            u = out.u0
            x = dyn.sim_time_step(out.x0_updated, u, TS)
            xs.append(x)
        states[name] = _np(torch.stack(xs, dim=1))
    secs = time.perf_counter() - t0
    (o1, v1), (o2, v2) = tick0_filter(
        track, params, sel, env, tick0["rti"][0], tick0["rti"][1],
        tick0["full"][1], obs, rad, dataclasses.replace(CONVERGED, **route))
    d = np.abs(states["full"] - states["rti"])
    return dict(dq=d[..., :7].max(axis=(1, 2)), ds=d[..., 7].max(axis=1),
                obj_first=_np(o1), obj_second=_np(o2), vio_first=_np(v1),
                vio_second=_np(v2), seconds=secs)


def roundoff_steps(r: dict, dtype) -> np.ndarray:
    """Lanes whose converged run took, at tick 0, a second SQP step that
    raised the objective and passed the filter only because the l1
    violation fell while both violations lay at roundoff
    (< ``VIO_ROUNDOFF`` eps of the dtype): the filter's dominance test
    decided by rounding.  (B,) bool."""
    floor = VIO_ROUNDOFF * torch.finfo(dtype).eps
    return ((r["obj_second"] > r["obj_first"])
            & (r["vio_second"] < r["vio_first"]) & (r["vio_first"] < floor))


def rti_vs_converged(dtype=torch.float32, device="cuda", lanes: int = LANES,
                     n: int = 60) -> dict:
    """`test_rti.py:36` on the port's routes (on the card K1-K4): 60
    nominal ticks, converged against RTI, both ok every tick, RTI SOLVED
    in one SQP iteration.  The exact home state (lane 0, the JAX test's
    start) within 1e-4 in q and s; every lane's q within JAX's float32
    figure; every other lane within 1e-4 in q and s unless its tick-0
    second step is one of :func:`roundoff_steps` (ROADMAP section 3: on
    the same starts JAX's float64 run of the JAX test's own settings
    drifts that way, as the port's float64 run on the CPU does), such
    lanes listed in ``roundoff_lanes`` with their drift."""
    r = ab_run(dtype, device, lanes, n, {})
    dq, ds = r["dq"], r["ds"]
    over = (dq >= AB_TOL) | (ds >= AB_TOL)
    explained = roundoff_steps(r, dtype)
    _check(not over[0], ("rti_ab home", dq, ds))
    _check((dq <= AB_JAX_F32_FIGURE).all(), ("rti_ab q", dq))
    _check(not (over & ~explained).any(), (
        "rti_ab", dq, ds, "tick-0 objective", r["obj_first"],
        r["obj_second"], "violation", r["vio_first"], r["vio_second"]))
    lanes_rs = [int(i) for i in np.flatnonzero(over)]
    return dict(gate="rti_ab", lanes=lanes, ticks=n,
                max_dq=float(dq.max()), max_ds=float(ds.max()),
                dq=dq.tolist(), ds=ds.tolist(), roundoff_lanes=lanes_rs,
                tick0_obj_rise=[float(r["obj_second"][i] - r["obj_first"][i])
                                for i in lanes_rs],
                tick0_vio=[[float(r["vio_first"][i]),
                            float(r["vio_second"][i])] for i in lanes_rs],
                seconds=r["seconds"])


def rti_vs_converged_jax_route(dtype=torch.float64, device="cpu",
                               lanes: int = 1, n: int = 60) -> dict:
    """The same A/B on :data:`JAX_ROUTE`, the JAX test's own settings
    (`test_rti.py:23-24`), held in float64: every lane within 1e-4 in q
    and s.  (In float32 no implementation meets 1e-4 on that route: JAX's
    3.1986e-4, the card's 3.504e-4; ROADMAP section 3.)"""
    r = ab_run(dtype, device, lanes, n, JAX_ROUTE)
    _check((r["dq"] < AB_TOL).all() and (r["ds"] < AB_TOL).all(), (
        "rti_ab_jax_route", r["dq"], r["ds"]))
    return dict(gate="rti_ab_jax_route", lanes=lanes, ticks=n,
                max_dq=float(r["dq"].max()), max_ds=float(r["ds"].max()),
                seconds=r["seconds"])


LADDER = (
    # (name, overrides, obstacle at the track's midpoint, required s)
    ("config1_box_only", {"cost": {"qOri": 0.0, "qSing": 0.0}}, False, 0.005),
    ("config2_orientation_singularity", {"cost": {"qOri": 50.0, "qSing": 1.0}},
     False, 0.005),
    ("config3_self_collision", {"param": {"tol_selcol": 2.0}}, False, 0.005),
    ("config4_full_stack_with_obstacle", {"param": {"tol_envcol": 8.0}}, True,
     0.003),
)


def ladder_run(track, x0: torch.Tensor, overrides: dict, n: int = 12,
               obs_pos=(3.0, 3.0, 3.0), obs_r: float = 0.0) -> np.ndarray:
    """`test_config_ladder.py::_run`: ``n`` converged ticks under the
    override, every tick ok; the final states (B, 9)."""
    dtype, dev = x0.dtype, x0.device
    sel, env = nets(dtype, dev)
    params, _ = load_params(overrides=overrides, dtype=dtype, device=dev)
    b = x0.shape[0]
    carry = init_carry(b, dtype, dev)
    x, u = x0, torch.zeros(b, 8, dtype=dtype, device=dev)
    obs = torch.tensor(np.asarray(obs_pos, dtype=np.float64), dtype=dtype,
                       device=dev).expand(b, 3)
    rad = torch.full((b,), obs_r, dtype=dtype, device=dev)
    for t in range(n):
        carry, out = mpc_step(track, params, sel, env, carry, x, u, obs, rad,
                              ts=TS, cfg=CONVERGED)
        _check(bool(out.ok.all()), (overrides, t, _np(out.status)))
        u = out.u0
        x = dyn.sim_time_step(out.x0_updated, u, TS)
    return _np(x)


def ladder_rung(name: str, track, x0: torch.Tensor) -> float:
    """One rung of :data:`LADDER`: the smallest final s over the lanes,
    held above the rung's bound."""
    _, overrides, with_obs, s_min = next(r for r in LADDER if r[0] == name)
    kw = {}
    if with_obs:
        kw = dict(obs_pos=tuple(_np(als.track_position(
            track, track.length * 0.5))), obs_r=0.05)
    s = float(ladder_run(track, x0, overrides, **kw)[:, 7].min())
    _check(s > s_min, (name, s, s_min))
    return s


def ladder_override(track, x0: torch.Tensor) -> tuple:
    """`test_runtime_param_override_changes_behavior`: desired EE velocity
    0.4 against 0.05 must give more than 1.5x the progress, every lane."""
    slow = ladder_run(track, x0, {"param": {"desired_ee_velocity": 0.05}})
    fast = ladder_run(track, x0, {"param": {"desired_ee_velocity": 0.4}})
    _check((fast[:, 7] > slow[:, 7] * 1.5).all(), (fast[:, 7], slow[:, 7]))
    return float(slow[:, 7].min()), float(fast[:, 7].min())


def config_ladder(dtype=torch.float32, device="cuda",
                  lanes: int = LANES) -> dict:
    """Every rung of the BASELINE config ladder and the runtime override."""
    track = circle_track(dtype, device)
    x0 = home_states(lanes, dtype, device)
    t0 = time.perf_counter()
    out = {name: ladder_rung(name, track, x0) for name, *_ in LADDER}
    out["override_slow_fast"] = ladder_override(track, x0)
    return dict(gate="ladder", lanes=lanes, min_s=out,
                seconds=time.perf_counter() - t0)


GATES = {"track": track_completion, "static": static_obstacle,
         "detour": detour_obstacle, "oscillating": oscillating_obstacle,
         "rti_obstacle": rti_obstacle, "rti_ab": rti_vs_converged,
         "ladder": config_ladder, "letter": letter_completion}
# the card's machine has no matplotlib: the letter gate runs when named
DEFAULT_GATES = [g for g in GATES if g != "letter"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run the closed-loop gates on the port and print each "
                    "gate's figures as one JSON line.")
    ap.add_argument("--only", nargs="*", choices=sorted(GATES),
                    default=DEFAULT_GATES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--lanes", type=int, default=LANES)
    args = ap.parse_args(argv)
    dtype = torch.float64 if args.float64 else torch.float32
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(timing.card_line())
    failed = []
    for name in args.only:
        t0 = time.perf_counter()
        try:
            res = GATES[name](dtype=dtype, device=device, lanes=args.lanes)
        except AssertionError as e:
            failed.append(name)
            res = dict(gate=name, failed=repr(e))
        res["wall_s"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    print(json.dumps({"gates": args.only, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
