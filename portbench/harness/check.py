"""How `correct` is decided: the program's ticks against the plain reference.

While the fleet runs, the harness keeps (by reference, with no device work)
the inputs and outputs of three ticks: the cold first tick of the set-up,
a window tick drawn from the seed, and the window's last tick.  Once the
window has closed and the program's state is freed, :func:`compare` takes
the rows of a seeded sample of lanes from each, runs the reference's tick
and plant on the same inputs (its own track, parameters and networks,
float64), and compares:

* ``horizon_gap``: the widest gap over the sampled lane-ticks between the
  program's and the reference's horizon (every knot's state and input,
  ``u0`` among them), each component over its normalization scale;
* ``horizon_gap_median``: the median over the sampled lane-ticks of each
  lane-tick's widest horizon gap;
* ``state_gap``: the widest gap over the updated state (the projection's
  s and the re-derived vs) and the plant's next state;
* ``ok_mismatch``: the sampled lane-ticks whose ``ok`` differs (exact).

A cell's limits file names the numbers it compares.

The window's ticks start from the program's own carry: the reference
follows it step by step from there, and the cold first tick checks the
start from the seed's states alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUMBERS = ("horizon_gap", "horizon_gap_median", "state_gap", "ok_mismatch")


@dataclasses.dataclass
class Snapshot:
    """One tick's inputs and outputs, whole-batch tensors held as they
    were."""

    carry: object
    x: torch.Tensor
    u: torch.Tensor
    out: object = None
    x_next: torch.Tensor = None


def sample(seed: int, batch: int, lanes: int, tick_below: int):
    """``(lanes, window tick)`` drawn from the seed."""
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    rows = np.sort(rng.choice(batch, size=min(lanes, batch), replace=False))
    return rows, int(rng.integers(0, max(tick_below, 1)))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx.to(t.device)).clone()


def gather(snap: Snapshot, rows, obs_pos, obs_radius) -> dict:
    """The sampled lanes' rows of a snapshot and of the fleet's obstacles,
    copied off the batch."""
    idx = torch.as_tensor(rows, dtype=torch.long)
    carry = {f.name: _rows(getattr(snap.carry, f.name), idx)
             for f in dataclasses.fields(snap.carry)}
    o = snap.out
    return dict(carry=carry, x=_rows(snap.x, idx), u=_rows(snap.u, idx),
                x0_updated=_rows(o.x0_updated, idx),
                horizon_x=_rows(o.horizon_x, idx),
                horizon_u=_rows(o.horizon_u, idx), ok=_rows(o.ok, idx),
                x_next=_rows(snap.x_next, idx),
                obs_pos=_rows(obs_pos, idx), obs_radius=_rows(obs_radius, idx))


def _lane_gap(a: torch.Tensor, b: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Each lane's widest |a - b| over ``scale``; inf where not finite."""
    d = ((a.to(b.dtype) - b).abs() / scale).flatten(1)
    return torch.where(torch.isfinite(d).all(1), d.amax(1),
                       torch.full_like(d[:, 0], float("inf")))


def compare(ref, gathered: list) -> dict:
    """The numbers of :data:`NUMBERS` over the gathered ticks, against
    ``ref`` (a :class:`~harness.sides.Reference`)."""
    from refmpcc.mpc import MPCCarry
    dev, dt = ref.device, ref.dtype
    t_x = ref.params.normalization.t_x
    t_u = ref.params.normalization.t_u
    horizon, state, mismatch = [], [], 0
    for g in gathered:
        args = [MPCCarry(**{
            k: v.to(dev, dt) if v.is_floating_point() else v.to(dev)
            for k, v in g["carry"].items()})] + [
            g[k].to(dev, dt) for k in ("x", "u", "obs_pos", "obs_radius")]
        _, out = ref.tick(*args)
        x_next = ref.plant(out.x0_updated, out.u0)
        horizon.append(torch.maximum(
            _lane_gap(g["horizon_x"].to(dev), out.horizon_x, t_x),
            _lane_gap(g["horizon_u"].to(dev), out.horizon_u, t_u)))
        state.append(torch.maximum(
            _lane_gap(g["x0_updated"].to(dev), out.x0_updated, t_x),
            _lane_gap(g["x_next"].to(dev), x_next, t_x)))
        mismatch += int((g["ok"].to(dev) != out.ok).sum())
    horizon, state = torch.cat(horizon), torch.cat(state)
    return dict(horizon_gap=float(horizon.max()),
                horizon_gap_median=float(horizon.quantile(0.5)),
                state_gap=float(state.max()), ok_mismatch=mismatch)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers the
    cell's limits name: each at or under its limit."""
    check = {k: {"value": numbers[k], "limit": limits[k]}
             for k in NUMBERS if k in limits}
    return all(v["value"] <= v["limit"] for v in check.values()), check
