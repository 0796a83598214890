"""The port's reference surface `api.MPCC` against the JAX package's
`api.MPCC`, float64 on the CPU, in JAX's default configuration (the
converged dense ADMM path with the plain loop, the plain kinematics with the
finite-difference manipulability gradient):

* the verify recipe's closed loop (home state, the repo's track, the RK4
  plant), tick for tick: ok, SQP and ADMM iteration counts equal; updated
  state, u0 and the whole horizon within 1e-8 (float64, summation order
  only), also across a mid-run ``setParam``;
* ``getRefPose`` / ``getContourError`` / ``getSplinePath`` /
  ``getTrackLength`` within 1e-12;
* ``runMPC(profile=True)``: the tick equals the untimed tick bit for bit,
  on both QP routes, and every phase time is positive.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.api import MPCC as JaxMPCC
from mpcc_manipulator_tpu.models.dynamics import sim_time_step as jax_sim
from mpcc_manipulator_tpu_torch.api import MPCC
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.params import SQPConfig

torch.set_num_threads(1)

X0 = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4, 0., 0.])
TICKS = 10
STATE_TOL = 1e-8
FLIP = {"param": {"desired_ee_velocity": 0.05},
        "cost": {"qOri_reduction_ratio": 0.1}}


def _pair():
    jax_mpc, mpc = JaxMPCC(), MPCC(device="cpu")
    jax_mpc.setTrack(X0)
    mpc.setTrack(X0)
    return jax_mpc, mpc


def _close(got, ref, what, tol=STATE_TOL):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err < tol, (what, err)


def _run_both(jax_mpc, mpc, ticks, flip_at=None):
    """The verify recipe on both controllers; every tick's outputs held."""
    xj, uj = X0.copy(), np.zeros(8)
    xp, up = X0.copy(), np.zeros(8)
    for t in range(ticks):
        if t == flip_at:
            jax_mpc.setParam(FLIP)
            mpc.setParam(FLIP)
        okj, xj_upd, uj, hj, ctj = jax_mpc.runMPC(xj, uj)
        okp, xp_upd, up, hp, ctp = mpc.runMPC(xp, up)
        assert okj and okp, t
        for key in ("sqp_iters", "qp_iters"):
            assert ctp[key] == ctj[key], (t, key, ctp[key], ctj[key])
        _close(xp_upd, xj_upd, f"tick {t} state")
        _close(up, uj, f"tick {t} u0")
        assert len(hp) == len(hj) == 11
        for k, (a, b) in enumerate(zip(hp, hj)):
            _close(a["state"], b["state"], f"tick {t} knot {k} state")
            _close(a["input"], b["input"], f"tick {t} knot {k} input")
        assert ctp["total"] > 0.0
        xj = np.asarray(jax_sim(jnp.asarray(xj_upd), jnp.asarray(uj), 0.01))
        xp = sim_time_step(torch.tensor(xp_upd), torch.tensor(up),
                           0.01).numpy()
    return xj, xp


def test_default_configuration_is_jax_default():
    mpc = MPCC(device="cpu")
    assert dataclasses.asdict(mpc.sqp_cfg) == dataclasses.asdict(
        JaxMPCC().sqp_cfg)
    assert mpc.Ts == 0.01 and mpc.pred_horizon == 10


def test_run_mpc_matches_jax():
    jax_mpc, mpc = _pair()
    xj, xp = _run_both(jax_mpc, mpc, TICKS)
    # s advanced along the track
    assert xp[7] > 0.005 and abs(xp[7] - xj[7]) < STATE_TOL


def test_set_param_midrun_matches_jax():
    """The reference's mid-run re-parameterization (slower EE velocity) at
    tick 3 of 8: both packages keep agreeing tick for tick, and, as in JAX,
    ``setParam`` puts the controller's configuration back to the default
    (from ``max_iter=20``, set on both before the run)."""
    jax_mpc, mpc = _pair()
    for m in (jax_mpc, mpc):
        m.sqp_cfg = dataclasses.replace(m.sqp_cfg, max_iter=20)
    _run_both(jax_mpc, mpc, 8, flip_at=3)
    assert float(mpc.params.model.desired_ee_velocity) == 0.05
    assert mpc.sqp_cfg.max_iter == 100
    assert dataclasses.asdict(mpc.sqp_cfg) == dataclasses.asdict(
        jax_mpc.sqp_cfg)


def test_set_param_rejects_keys_off_the_whitelist():
    mpc = MPCC(device="cpu")
    with pytest.raises(ValueError, match="groups"):
        mpc.setParam({"model": {"max_dist_proj": 0.1}})
    with pytest.raises(ValueError, match="Keys for cost"):
        mpc.setParam({"cost": {"qC": 1.0, "q_c": 2.0}})
    with pytest.raises(RuntimeError, match="Set Track"):
        mpc.runMPC(X0, np.zeros(8))


def test_track_queries_match_jax():
    jax_mpc, mpc = _pair()
    assert abs(mpc.getTrackLength() - jax_mpc.getTrackLength()) < 1e-12
    for got, ref in zip(mpc.getSplinePath(), jax_mpc.getSplinePath()):
        _close(got, ref, "spline path", 1e-12)
    for s in (0.0, 0.137, 0.5 * jax_mpc.getTrackLength()):
        for got, ref in zip(mpc.getRefPose(s), jax_mpc.getRefPose(s)):
            _close(got, ref, f"ref pose at {s}", 1e-12)
        ee = np.array([0.3, 0.1, 0.5])
        assert abs(mpc.getContourError(s, ee)
                   - jax_mpc.getContourError(s, ee)) < 1e-12


@pytest.mark.parametrize("route", ["reference", "bench"])
def test_profiled_tick_equals_the_fused_tick(route):
    """``runMPC(profile=True)`` runs the same tick phase by phase: the same
    outputs bit for bit, each phase time positive and within the total."""
    profiled, fused = MPCC(device="cpu"), MPCC(device="cpu")
    for mpc in (profiled, fused):
        if route == "bench":
            mpc.sqp_cfg = SQPConfig()
        mpc.setTrack(X0)
    x_p, u_p, x_f, u_f = X0.copy(), np.zeros(8), X0.copy(), np.zeros(8)
    for tick in range(3):
        ok_p, x_p, u_p, hor_p, ct = profiled.runMPC(x_p, u_p, profile=True)
        ok_f, x_f, u_f, hor_f, ct_f = fused.runMPC(x_f, u_f)
        assert ok_p and ok_f
        assert np.array_equal(x_p, x_f) and np.array_equal(u_p, u_f)
        assert all(np.array_equal(a["state"], b["state"])
                   for a, b in zip(hor_p, hor_f))
        for key in ("set_env", "set_qp", "solve_qp", "get_alpha", "total"):
            assert np.isfinite(ct[key]) and ct[key] > 0.0, (key, ct)
        assert (ct["set_env"] + ct["set_qp"] + ct["solve_qp"]
                + ct["get_alpha"]) <= ct["total"]
        assert ct["sqp_iters"] == ct_f["sqp_iters"] >= 1
        assert ct_f["set_qp"] == 0.0 and ct_f["total"] > 0.0
