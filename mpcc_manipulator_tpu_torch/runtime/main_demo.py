"""Closed-loop demo application (`mpcc_manipulator_tpu/runtime/main_demo.py`;
the reference's `cpp/src/main.cpp` / `python/main.py`).

Runs the full closed loop on the configured track through the port's
:class:`..api.MPCC`, logs per-tick telemetry, writes ``splined_path.txt``
and ``debug.txt`` in the reference formats, and reports mean/max solve
times (`main.cpp:181-192`).  Optional matplotlib timing plot
(`python/main.py:116-134`).

Usage:  python -m mpcc_manipulator_tpu_torch.runtime.main_demo [--n_sim N]
        [--track PATH | --letter TEXT] [--plot] [--float32]
        [--device cuda|cpu] [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_sim", type=int, default=None,
                    help="max ticks (default: config.json n_sim)")
    ap.add_argument("--track", type=str, default=None)
    ap.add_argument("--letter", type=str, default=None, metavar="TEXT",
                    help="trace TEXT with the EE (reference letter demo, "
                         "`track_from_letter.py` / DYROS_letter.mp4); "
                         "generates the track JSON and overrides --track")
    ap.add_argument("--letter_height", type=float, default=0.10)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--float32", action="store_true",
                    help="production precision instead of conformance f64")
    ap.add_argument("--out_dir", type=str, default=".")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the controller's device (default: the card)")
    args = ap.parse_args(argv)

    from .. import compat
    from ..api import MPCC
    from ..models.dynamics import sim_time_step
    from .native import TelemetryRing

    dev = torch.device(args.device)
    track_path = args.track
    if args.letter:
        from .track_gen import letter_track, write_track
        track_path = os.path.join(args.out_dir,
                                  f"track_letter_{args.letter}.json")
        write_track(track_path, letter_track(args.letter,
                                             height=args.letter_height))
        print(f"letter track '{args.letter}' -> {track_path}")

    dtype = torch.float32 if args.float32 else torch.float64
    mpc = MPCC(track_path=track_path, dtype=dtype, device=dev)
    n_sim = args.n_sim if args.n_sim is not None else mpc.jsonConfig["n_sim"]

    state = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4, 0., 0.])
    inp = np.zeros(8)
    mpc.setTrack(state)
    spline_pos, spline_ori, spline_s = mpc.getSplinePath()

    # splined_path.txt parity (`main.cpp:84-98`)
    with open(os.path.join(args.out_dir, "splined_path.txt"), "w") as f:
        for pos, ori in zip(spline_pos, spline_ori):
            quat = compat.RotToQuat(ori, device=dev)
            f.write(" ".join(map(str, np.concatenate([pos, quat]))) + "\n")

    robot = compat.RobotModel(device=dev)
    selcol = compat.SelfCollisionNN(device=dev)
    total_times = []
    end_pos, end_ori, end_s = spline_pos[-1], spline_ori[-1], spline_s[-1]

    # per-tick telemetry through the native non-blocking ring buffer
    # (falls back to in-memory buffering without the C++ library)
    debug_record_len = 7 + 7 + 3 + 5   # q, dq, ee_pos, [mani, min_dist, s, vs, t]
    debug_ring = TelemetryRing(os.path.join(args.out_dir, "debug.txt"),
                               debug_record_len, capacity=8192, text_mode=True)

    for tick in range(n_sim):
        ok, state, inp, horizon, ct = mpc.runMPC(state, inp)
        if not ok:
            print("MPC did not solve properly!!")
            break
        state = sim_time_step(
            torch.as_tensor(state, dtype=dtype, device=dev),
            torch.as_tensor(inp, dtype=dtype, device=dev),
            mpc.Ts).cpu().numpy()
        total_times.append(ct["total"])

        q = state[:7]
        ee_pos = robot.getEEPosition(q)
        ee_ori = robot.getEEOrientation(q)
        mani = robot.getEEManipulability(q)
        min_dist, _ = selcol.calculateMlpOutput(q)
        debug_ring.append(np.concatenate(
            [q, inp[:7], ee_pos, [mani, float(min_dist[0]), state[7], state[8],
                                  ct["total"]]]))

        if tick % 50 == 0:
            print(f"tick {tick:5d}  s={state[7]:.4f}/{end_s:.4f} "
                  f"vs={state[8]:.4f} mani={mani:.4f} "
                  f"min_dist={float(min_dist[0]):.2f}cm "
                  f"t={ct['total'] * 1e3:.2f}ms")

        ori_err = np.linalg.norm(compat.Log(end_ori.T @ ee_ori, device=dev))
        if (np.linalg.norm(ee_pos - end_pos) < 1e-2 and ori_err < 1e-3
                and abs(state[7] - end_s) < 1e-2):
            print("End point reached!!!")
            break

    debug_ring.close()
    if debug_ring.dropped:
        print(f"warning: telemetry ring dropped {debug_ring.dropped} records")

    times = np.asarray(total_times[1:]) if len(total_times) > 1 else np.asarray(total_times)
    print(f"ticks: {len(total_times)}  "
          f"mean solve: {times.mean() * 1e3:.3f} ms  "
          f"max solve: {times.max() * 1e3:.3f} ms  "
          f"p99: {np.percentile(times, 99) * 1e3:.3f} ms")

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.figure(figsize=(8, 4))
            plt.plot(np.asarray(total_times) * 1e3, label="total")
            plt.axhline(mpc.Ts * 1e3, color="r", ls="--", label="Ts budget")
            plt.xlabel("tick")
            plt.ylabel("solve time [ms]")
            plt.legend()
            plt.savefig(os.path.join(args.out_dir, "timing.png"), dpi=120)
            print("wrote timing.png")
        except ImportError:
            print("matplotlib unavailable; skipping plot")


if __name__ == "__main__":
    main()
