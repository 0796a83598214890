"""External-simulator bridge (`mpcc_manipulator_tpu/runtime/sim_bridge.py`;
capability parity with the reference's `python/main_w_isaac.py`).

The reference drives Isaac Sim over ROS1 topics: it subscribes to
``/joint_states``, runs one MPC tick per period, and publishes a
``/joint_command`` JointState whose name list starts with the four Husky
wheel joints zero-padded before the seven Panda joints
(`main_w_isaac.py:205-229`), plus path telemetry topics
(``/mpcc/global_path``, ``splined_path``, ``local_path``,
``ref_local_path``, `main_w_isaac.py:140-144`).

This module reproduces that driver against a pluggable transport, on the
port's :class:`..api.MPCC`:

* :class:`LoopbackSimTransport` — an in-process plant (1 ms RK4 substeps,
  the reference's `Integrator::simTimeStep`, float64 on the host) that
  answers ``/joint_command`` with ``/joint_states``, standing in for Isaac
  Sim;
* :func:`make_rospy_transport` — the same topic contract over rospy,
  constructed only if ``rospy`` imports.

Message dicts mirror ``sensor_msgs/JointState``: ``{"name": [...],
"position": [...], "velocity": [...]}``.  Run:

    python -m mpcc_manipulator_tpu_torch.runtime.sim_bridge --n_sim 100 \\
        [--device cuda|cpu] [--float32] [--ros]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Protocol

import numpy as np
import torch

from ..models.dynamics import sim_time_step

PANDA_JOINT_NAMES = [f"panda_joint{i}" for i in range(1, 8)]
# Husky wheel names, zero-padded ahead of the arm joints like the reference
WHEEL_JOINT_NAMES = ["front_left_wheel", "front_right_wheel",
                     "rear_left_wheel", "rear_right_wheel"]


def _plant_step(x: np.ndarray, u: np.ndarray, ts: float) -> np.ndarray:
    """One plant period in float64 on the host (numpy in and out)."""
    return sim_time_step(torch.tensor(x, dtype=torch.float64),
                         torch.tensor(u, dtype=torch.float64), ts).numpy()


class Transport(Protocol):
    def publish(self, topic: str, msg: dict) -> None: ...
    def subscribe(self, topic: str, callback: Callable[[dict], None]) -> None: ...
    def spin_once(self) -> None: ...


class LoopbackSimTransport:
    """In-process stand-in for Isaac Sim: integrates the plant (RK4, 1 ms
    substeps) on every ``/joint_command`` and republishes ``/joint_states``."""

    def __init__(self, q0: np.ndarray, ts: float = 0.01):
        self._subs: dict[str, list[Callable[[dict], None]]] = {}
        self._q = np.asarray(q0, dtype=float).copy()
        self._dq = np.zeros_like(self._q)
        self._ts = ts
        self.published: dict[str, list[dict]] = {}

    def subscribe(self, topic, callback):
        self._subs.setdefault(topic, []).append(callback)

    def publish(self, topic, msg):
        self.published.setdefault(topic, []).append(msg)
        if topic != "/joint_command":
            return
        # Isaac applies the velocity command; integrate the arm joints with
        # the same fine-step integrator the reference plant uses
        vel = dict(zip(msg["name"], msg["velocity"]))
        dq = np.array([vel.get(n, 0.0) for n in PANDA_JOINT_NAMES])
        x2 = _plant_step(np.concatenate([self._q, [0.0, 0.0]]),
                         np.concatenate([dq, [0.0]]), self._ts)
        self._q = x2[:7]
        self._dq = dq

    def _emit_state(self):
        msg = {"name": list(PANDA_JOINT_NAMES),
               "position": self._q.tolist(),
               "velocity": self._dq.tolist()}
        for cb in self._subs.get("/joint_states", []):
            cb(msg)

    def spin_once(self):
        # deliver the current simulated state (deferred, like a real topic
        # queue — synchronous emission would recurse command->state->command)
        self._emit_state()

    def start(self):
        self._emit_state()


def make_rospy_transport():
    """ROS1 transport with the reference's exact topic contract.  Raises
    ImportError when rospy is unavailable."""
    import rospy  # gated import
    from sensor_msgs.msg import JointState

    class RospyTransport:
        def __init__(self):
            rospy.init_node("MPCC_ISAAC", anonymous=True)
            self._pubs = {}

        def subscribe(self, topic, callback):
            def _cb(data):
                callback({"name": list(data.name),
                          "position": list(data.position),
                          "velocity": list(data.velocity)})
            rospy.Subscriber(topic, JointState, _cb)

        def publish(self, topic, msg):
            if topic not in self._pubs:
                self._pubs[topic] = rospy.Publisher(topic, JointState,
                                                    queue_size=10)
            m = JointState()
            m.name = msg["name"]
            m.position = msg["position"]
            m.velocity = msg["velocity"]
            self._pubs[topic].publish(m)

        def spin_once(self):
            pass

    return RospyTransport()


class IsaacBridge:
    """The reference driver loop: joint_states -> MPC tick -> joint_command.

    Telemetry dicts carry the channels the reference publishes as path
    topics; the transport decides where they go.  The controller is
    ``MPCC(dtype=dtype, device=device)`` (the card unless ``device``
    says otherwise).
    """

    def __init__(self, transport: Transport, ts: float = 0.01,
                 dtype=torch.float64, pad_wheels: bool = True,
                 real_time: bool = False, device="cuda"):
        from ..api import MPCC

        self.transport = transport
        self.ts = ts
        self.pad_wheels = pad_wheels
        self.real_time = real_time
        self.mpc = MPCC(dtype=dtype, device=device)
        self._state = None
        self._input = np.zeros(8)
        self._log = {"s": [], "solve_time": [], "q": [], "ok": []}
        transport.subscribe("/joint_states", self._on_joint_state)

    # -- one tick per received state (reference while-loop body)
    def _on_joint_state(self, msg: dict):
        pos = dict(zip(msg["name"], msg["position"]))
        q = np.array([pos[n] for n in PANDA_JOINT_NAMES])
        if self._state is None:
            self._state = np.concatenate([q, [0.0, 0.0]])
            self.mpc.setTrack(self._state)
            spline_pos, _, _ = self.mpc.getSplinePath()
            self.transport.publish("/mpcc/splined_path", {
                "name": [], "position": spline_pos.reshape(-1).tolist(),
                "velocity": []})
            return
        self._state[:7] = q

        t0 = time.perf_counter()
        ok, state, u, horizon, _ = self.mpc.runMPC(self._state, self._input)
        solve_time = time.perf_counter() - t0
        self._state = np.array(state, dtype=np.float64)
        self._input = np.array(u, dtype=np.float64)
        self._log["s"].append(float(self._state[7]))
        self._log["solve_time"].append(solve_time)
        self._log["q"].append(q.copy())
        self._log["ok"].append(bool(ok))
        if not ok:
            return

        # the command the reference sends Isaac (`main_w_isaac.py:224-229`):
        # positions from the *predicted* state, velocities from u0;
        # wheels zero-padded ahead of the arm joints
        names = (WHEEL_JOINT_NAMES if self.pad_wheels else []) + \
            PANDA_JOINT_NAMES
        npad = len(WHEEL_JOINT_NAMES) if self.pad_wheels else 0
        pred = _plant_step(self._state, self._input, self.ts)
        self.transport.publish("/joint_command", {
            "name": names,
            "position": [0.0] * npad + pred[:7].tolist(),
            "velocity": [0.0] * npad + self._input[:7].tolist(),
        })
        # local-path telemetry (reference /mpcc/local_path)
        hx = np.asarray([h["state"] for h in horizon])
        self.transport.publish("/mpcc/local_path", {
            "name": [], "position": hx[:, :7].reshape(-1).tolist(),
            "velocity": []})

        if self.real_time and solve_time < self.ts:
            time.sleep(self.ts - solve_time)

    @property
    def log(self):
        return self._log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n_sim", type=int, default=100)
    ap.add_argument("--ros", action="store_true",
                    help="use the rospy transport instead of the loopback sim")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the controller's device (default: the card)")
    args = ap.parse_args(argv)

    q0 = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4])
    transport = make_rospy_transport() if args.ros \
        else LoopbackSimTransport(q0)
    bridge = IsaacBridge(
        transport, dtype=torch.float32 if args.float32 else torch.float64,
        device=args.device)
    transport.start()          # first state sets the track
    for _ in range(args.n_sim):
        transport.spin_once()  # one joint_states -> one MPC tick
    lg = bridge.log
    if lg["solve_time"]:
        st = np.asarray(lg["solve_time"])
        print(f"ticks={len(st)} ok_frac={np.mean(lg['ok']):.3f} "
              f"s_final={lg['s'][-1]:.4f} "
              f"solve ms mean={st.mean()*1e3:.2f} max={st.max()*1e3:.2f}")


if __name__ == "__main__":
    main()
