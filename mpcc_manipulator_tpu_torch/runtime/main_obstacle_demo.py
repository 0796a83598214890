"""Closed loop with a moving sphere obstacle
(`mpcc_manipulator_tpu/runtime/main_obstacle_demo.py`; the reference's
`python/main_w_sim.py`).

The obstacle oscillates vertically (`main_w_sim.py:125-130`); per-tick
telemetry (EE speed, manipulability, self/env min distances, contour error)
is logged and optionally exported to ``.mat`` (`main_w_sim.py:251-256`,
scipy).  ROS publishing is out of scope here; the telemetry dict carries
the same channels the reference publishes as topics.

Usage: python -m mpcc_manipulator_tpu_torch.runtime.main_obstacle_demo
       [--n_sim N] [--is_obs | --no_obs] [--obs_radius R] [--mat out.mat]
       [--plot fig.png] [--float32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_sim", type=int, default=500)
    ap.add_argument("--is_obs", action="store_true", default=True)
    ap.add_argument("--no_obs", dest="is_obs", action="store_false")
    ap.add_argument("--obs_radius", type=float, default=0.05)
    ap.add_argument("--mat", type=str, default=None)
    ap.add_argument("--plot", type=str, default=None,
                    help="write the 4-panel analysis figure here")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the controller's device (default: the card)")
    args = ap.parse_args(argv)

    from .. import compat
    from ..api import MPCC
    from ..models.dynamics import sim_time_step

    dev = torch.device(args.device)
    dtype = torch.float32 if args.float32 else torch.float64
    mpc = MPCC(dtype=dtype, device=dev)
    robot = compat.RobotModel(device=dev)
    selcol = compat.SelfCollisionNN(device=dev)
    envcol = compat.EnvCollisionNN(device=dev)

    state = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4, 0., 0.])
    inp = np.zeros(8)
    mpc.setTrack(state)
    spline_pos, spline_ori, spline_s = mpc.getSplinePath()

    # obstacle at the track midpoint, oscillating in z (`main_w_sim.py:41-46`)
    obs_center = spline_pos[len(spline_pos) // 2].copy()
    tele = {k: [] for k in ["ee_speed", "mani", "sel_min_dist", "env_min_dist",
                            "contour_error", "s", "obs_z", "solve_time", "q",
                            "qdot"]}

    for tick in range(args.n_sim):
        obs_pos = obs_center.copy()
        obs_pos[2] += 0.1 * np.sin(2 * np.pi * tick / 200.0)
        radius = args.obs_radius if args.is_obs else 0.0
        if not args.is_obs:
            obs_pos = np.array([3.0, 3.0, 3.0])

        ok, state, inp, horizon, ct = mpc.runMPC(state, inp, obs_pos, radius)
        if not ok:
            print("MPC did not solve properly!!")
            break
        state = sim_time_step(
            torch.as_tensor(state, dtype=dtype, device=dev),
            torch.as_tensor(inp, dtype=dtype, device=dev),
            mpc.Ts).cpu().numpy()

        q = state[:7]
        ee_vel = robot.getEEJacobianv(q) @ inp[:7]
        sel_d, _ = selcol.calculateMlpOutput(q)
        env_d, _ = envcol.calculateMlpOutput(np.concatenate([q, obs_pos]))
        tele["ee_speed"].append(np.linalg.norm(ee_vel))
        tele["mani"].append(robot.getEEManipulability(q))
        tele["sel_min_dist"].append(float(sel_d[0]))
        tele["env_min_dist"].append(float(np.min(env_d)))
        tele["contour_error"].append(
            mpc.getContourError(state[7], robot.getEEPosition(q)))
        tele["s"].append(state[7])
        tele["obs_z"].append(obs_pos[2])
        tele["solve_time"].append(ct["total"])
        tele["q"].append(q.copy())
        tele["qdot"].append(inp[:7].copy())

        if tick % 50 == 0:
            print(f"tick {tick:4d} s={state[7]:.4f} env_min={tele['env_min_dist'][-1]:.2f}cm "
                  f"sel_min={tele['sel_min_dist'][-1]:.2f}cm ce={tele['contour_error'][-1]*1e3:.2f}mm")

        if abs(state[7] - spline_s[-1]) < 1e-2:
            print("End point reached!!!")
            break

    if args.mat:
        try:
            from scipy.io import savemat
            savemat(args.mat, {k: np.asarray(v) for k, v in tele.items()})
            print(f"wrote {args.mat}")
        except ImportError:
            print("scipy unavailable; skipping .mat export")

    if args.plot and tele["s"]:
        # 4-panel analysis figure (reference `main_w_sim.py:262-330`):
        # EE speed, manipulability, min collision distances, contour error
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(2, 2, figsize=(11, 7))
        t = np.arange(len(tele["s"])) * mpc.Ts
        axs[0, 0].plot(t, tele["ee_speed"])
        axs[0, 0].set_title("EE speed [m/s]")
        axs[0, 1].plot(t, tele["mani"])
        axs[0, 1].axhline(float(mpc.params.model.tol_sing), color="r",
                          ls="--")
        axs[0, 1].set_title("manipulability")
        axs[1, 0].plot(t, tele["sel_min_dist"], label="self")
        axs[1, 0].plot(t, tele["env_min_dist"], label="env")
        axs[1, 0].axhline(float(mpc.params.model.tol_selcol), color="r",
                          ls="--")
        axs[1, 0].legend()
        axs[1, 0].set_title("min collision distance [cm]")
        axs[1, 1].plot(t, np.asarray(tele["contour_error"]) * 1e3)
        axs[1, 1].set_title("contour error [mm]")
        for ax in axs.flat:
            ax.set_xlabel("time [s]")
            ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(args.plot)
        print(f"wrote {args.plot}")

    st = np.asarray(tele["solve_time"][1:])
    if st.size:
        print(f"mean solve {st.mean()*1e3:.2f} ms, max {st.max()*1e3:.2f} ms; "
              f"min env dist {min(tele['env_min_dist']):.2f} cm")


if __name__ == "__main__":
    main()
