"""The runtime layer's closed loops on the port against the JAX package's,
float64 on the CPU, in the JAX package's default configuration (the one
both packages' `api.MPCC` run):

* `sim_bridge`: `tests/test_sim_bridge.py:10` on the port (12 ticks over
  the loopback plant, the JointState topic contract), and the same 12
  `/joint_command` messages from the port's bridge and JAX's, within
  `tests/test_torch_api.py`'s 1e-8;
* `main_demo` / `main_obstacle_demo`: both packages' `main()` on the same
  arguments (``--n_sim 20``): `splined_path.txt` equal to 1e-12 (parsed as
  floats), `debug.txt`'s q, dq, EE, m, min-distance, s and vs columns
  within 1e-8 (the time column is excluded), the `.mat` keys and
  telemetry.
"""

import sys

import numpy as np
import pytest
import torch
from scipy.io import loadmat

from mpcc_manipulator_tpu.runtime import main_demo as jmain_demo
from mpcc_manipulator_tpu.runtime import main_obstacle_demo as jmain_obs
from mpcc_manipulator_tpu.runtime import sim_bridge as jsim_bridge
from mpcc_manipulator_tpu_torch.runtime import main_demo, main_obstacle_demo
from mpcc_manipulator_tpu_torch.runtime.sim_bridge import (
    IsaacBridge, LoopbackSimTransport, PANDA_JOINT_NAMES, WHEEL_JOINT_NAMES,
    main as bridge_main)

torch.set_num_threads(1)

Q0 = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4])
STATE_TOL = 1e-8     # tests/test_torch_api.py: runMPC, float64
N_SIM = 20


def _bridge_run(bridge_cls, transport_cls, **kw):
    transport = transport_cls(Q0)
    bridge = bridge_cls(transport, **kw)
    transport.start()
    for _ in range(12):
        transport.spin_once()
    return bridge, transport


def test_bridge_closed_loop_and_topic_contract():
    bridge, transport = _bridge_run(IsaacBridge, LoopbackSimTransport,
                                    device="cpu")
    lg = bridge.log
    assert len(lg["s"]) == 12
    assert all(lg["ok"])
    # progress strictly advances after the ramp-up ticks
    assert lg["s"][-1] > lg["s"][2] > 0.0
    cmds = transport.published["/joint_command"]
    assert len(cmds) == 12
    msg = cmds[-1]
    # reference contract: husky wheels zero-padded ahead of the arm joints
    assert msg["name"][:4] == WHEEL_JOINT_NAMES
    assert msg["name"][4:] == PANDA_JOINT_NAMES
    assert msg["position"][:4] == [0.0] * 4
    assert msg["velocity"][:4] == [0.0] * 4
    assert len(msg["position"]) == 11
    # commanded velocities are the MPC's u0
    assert np.allclose(msg["velocity"][4:], bridge._input[:7])
    # telemetry channels present (reference path topics)
    assert "/mpcc/splined_path" in transport.published
    assert "/mpcc/local_path" in transport.published


def test_bridge_commands_match_jax():
    """The 12 commands and local paths of both bridges, float64: names
    equal, positions and velocities within 1e-8; the splined path within
    1e-12."""
    _, port = _bridge_run(IsaacBridge, LoopbackSimTransport, device="cpu")
    _, ref = _bridge_run(jsim_bridge.IsaacBridge,
                         jsim_bridge.LoopbackSimTransport)
    for topic in ("/joint_command", "/mpcc/local_path"):
        got, want = port.published[topic], ref.published[topic]
        assert len(got) == len(want) == 12
        for g, w in zip(got, want):
            assert g["name"] == w["name"]
            for key in ("position", "velocity"):
                assert len(g[key]) == len(w[key])
                if g[key]:
                    gap = np.abs(np.subtract(g[key], w[key])).max()
                    assert gap < STATE_TOL, (topic, key, gap)
    (sp,), (sj,) = (port.published["/mpcc/splined_path"],
                    ref.published["/mpcc/splined_path"])
    np.testing.assert_allclose(sp["position"], sj["position"], atol=1e-12,
                               rtol=0)


def test_bridge_main_runs(capsys):
    bridge_main(["--n_sim", "3", "--device", "cpu"])
    assert "ticks=3 ok_frac=1.000" in capsys.readouterr().out


def test_demo_device_cuda_needs_a_card(tmp_path):
    """``--device cuda`` (the default) runs on the card, and raises without
    one: no fallback to the CPU."""
    args = ["--n_sim", "1", "--out_dir", str(tmp_path)]
    if torch.cuda.is_available():
        main_demo.main(args)
        assert (tmp_path / "debug.txt").exists()
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            main_demo.main(args)


def _run_jax_main(monkeypatch, module, args):
    monkeypatch.setattr(sys, "argv", [module.__name__, *args, "--cpu"])
    module.main()


def test_main_demo_matches_jax(tmp_path, monkeypatch):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    main_demo.main(["--n_sim", str(N_SIM), "--out_dir", str(port_dir),
                    "--device", "cpu"])
    _run_jax_main(monkeypatch, jmain_demo,
                  ["--n_sim", str(N_SIM), "--out_dir", str(jax_dir)])
    sp, sj = (np.loadtxt(d / "splined_path.txt") for d in (port_dir, jax_dir))
    assert sp.shape == sj.shape and sp.shape[1] == 7
    np.testing.assert_allclose(sp, sj, atol=1e-12, rtol=0)
    dp, dj = (np.loadtxt(d / "debug.txt") for d in (port_dir, jax_dir))
    assert dp.shape == dj.shape == (N_SIM, 22)
    # q, dq, EE, m, min-distance, s, vs; column 21 is the solve time
    gap = np.abs(dp[:, :21] - dj[:, :21]).max()
    assert gap < STATE_TOL, gap
    assert (dp[:, 21] > 0).all()
    assert (np.diff(dp[:, 19]) > 0).all()          # s rises every tick


def test_main_obstacle_demo_matches_jax(tmp_path, monkeypatch):
    port_mat, jax_mat = str(tmp_path / "port.mat"), str(tmp_path / "jax.mat")
    main_obstacle_demo.main(["--n_sim", str(N_SIM), "--mat", port_mat,
                             "--device", "cpu"])
    _run_jax_main(monkeypatch, jmain_obs,
                  ["--n_sim", str(N_SIM), "--mat", jax_mat])
    mp, mj = loadmat(port_mat), loadmat(jax_mat)
    keys = lambda m: sorted(k for k in m if not k.startswith("__"))
    assert keys(mp) == keys(mj) == sorted(
        ["ee_speed", "mani", "sel_min_dist", "env_min_dist", "contour_error",
         "s", "obs_z", "solve_time", "q", "qdot"])
    for k in keys(mp):
        assert mp[k].shape == mj[k].shape, k
        if k != "solve_time":
            gap = np.abs(mp[k] - mj[k]).max()
            assert gap < STATE_TOL, (k, gap)
    assert mp["q"].shape == (N_SIM, 7)
