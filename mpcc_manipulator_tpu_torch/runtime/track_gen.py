"""Offline track generators (`mpcc_manipulator_tpu/runtime/track_gen.py`,
numpy only; capability parity with `cpp/Params/track.py` and
`cpp/Params/track_from_letter.py`).

Produces reference-format track JSON files:

* :func:`lissajous_track` — Lissajous figures with a constant tool
  orientation (flipped-Z, tool pointing down), like `track.py:1-35`.
* :func:`letter_track` — letter/word tracing.  The reference extracts a 2-D
  pen trajectory from a video of handwriting (`track_from_letter.py`),
  scales it, and places it in the robot's Y-Z plane with the same constant
  flipped orientation.  We reproduce the capability without the video
  dependency: glyph outlines come straight from font data
  (``matplotlib.textpath``), are chained into one continuous polyline
  (the arc-length spline needs a single connected curve, exactly like the
  reference's continuous pen trace), resampled ~uniformly in arc length,
  and written to the identical waypoint JSON schema.

``letter_track`` needs matplotlib (its font data), imported when it is
called; nothing else here does.

    python -m mpcc_manipulator_tpu_torch.runtime.track_gen track.json \
        [--letters TEXT --height H --n_points N]
"""

from __future__ import annotations

import json

import numpy as np


def lissajous_track(radius: float = 0.1, amp=(2.2, 2.6, 0.0), n_points: int = 100,
                    freq=(1, 2, 1), phase: float = np.pi / 2) -> dict:
    """Lissajous curve in the EE task plane, constant downward orientation."""
    t = np.linspace(phase, 2 * np.pi + phase, n_points)
    x = amp[0] * radius * np.sin(freq[0] * t)
    y = amp[1] * radius * np.sin(freq[1] * t)
    z = amp[2] * radius * np.cos(freq[2] * t)
    # constant orientation: x forward, y/z flipped (tool pointing down);
    # as quaternion (x, y, z, w) this is a rotation of pi about x.
    quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n_points, 1))
    return {
        "X": x.tolist(), "Y": y.tolist(), "Z": z.tolist(),
        "quat_X": quat[:, 0].tolist(), "quat_Y": quat[:, 1].tolist(),
        "quat_Z": quat[:, 2].tolist(), "quat_W": quat[:, 3].tolist(),
    }


def _resample_polyline(pts: np.ndarray, n: int) -> np.ndarray:
    """Resample an ordered 2-D polyline to ``n`` ~arc-length-uniform points."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] <= 0.0:
        raise ValueError("degenerate polyline (zero length)")
    si = np.linspace(0.0, s[-1], n)
    x = np.interp(si, s, pts[:, 0])
    y = np.interp(si, s, pts[:, 1])
    out = np.stack([x, y], axis=1)
    # the arc-length spline fit needs strictly increasing chord length:
    # drop consecutive duplicates introduced by corner-heavy glyphs
    keep = np.concatenate([[True],
                           np.linalg.norm(np.diff(out, axis=0), axis=1) > 1e-9])
    return out[keep]


def _smooth_polyline(pts: np.ndarray, window: int) -> np.ndarray:
    """Boxcar-smooth an open polyline (reflected ends, endpoints pinned).

    Font glyph outlines have exact corners; the reference's pen trace is
    extracted from a VIDEO of handwriting (`track_from_letter.py`) and is
    therefore naturally smooth.  A small moving average restores that
    property — without it the arc-length spline turns each corner into a
    curvature spike the closed-loop controller cannot track (measured r4:
    the DYROS trace stalls mid-'O' at a cusp).
    """
    if window < 3:
        return pts
    pad = window // 2
    ext = np.concatenate([pts[pad:0:-1], pts, pts[-2:-2 - pad:-1]], axis=0)
    kern = np.ones(window) / window
    sm = np.stack([np.convolve(ext[:, i], kern, mode="valid")
                   for i in range(pts.shape[1])], axis=1)
    sm = sm[: len(pts)]
    sm[0], sm[-1] = pts[0], pts[-1]
    return sm


def letter_track(text: str = "DYROS", height: float = 0.25,
                 n_points: int = 300, font: str | None = None,
                 smooth_window: int = 7) -> dict:
    """Word-tracing track in the robot Y-Z plane (X = 0), constant flipped
    orientation — the same output convention as the reference's video tracer
    (`track_from_letter.py`: X=0, Y=horizontal, Z=vertical, quat=(1,0,0,0)).

    Glyph outlines are chained left-to-right into one continuous polyline
    (nearest-endpoint linking, reversing loops when that shortens the hop),
    then resampled to ``n_points`` waypoints and scaled to ``height`` meters
    of letter height.
    """
    from matplotlib.font_manager import FontProperties
    from matplotlib.textpath import TextPath

    prop = FontProperties(family=font) if font else FontProperties()
    tp = TextPath((0, 0), text, size=1.0, prop=prop)
    polys = [np.asarray(p) for p in tp.to_polygons() if len(p) >= 3]
    if not polys:
        raise ValueError(f"no glyph outlines for text {text!r}")
    # Drop inner counters (the holes of D/O/R/...): a pen trace follows the
    # letter shape once — tracing a ~2 cm-radius counter at demo scale is
    # a curvature spike the contouring controller (correctly) cannot track
    # at speed (measured r4: the DYROS loop stalls inside 'O').
    from matplotlib.path import Path as _MplPath
    outers = []
    for p in polys:
        centroid = p.mean(axis=0)
        inside_other = any(
            q is not p and _MplPath(q).contains_point(centroid)
            for q in polys)
        if not inside_other:
            outers.append(p)
    polys = outers or polys
    # left-to-right writing order
    polys.sort(key=lambda p: p[:, 0].min())

    chain = [polys[0]]
    for p in polys[1:]:
        tail = chain[-1][-1]
        # rotate the closed loop to start at the vertex nearest the pen,
        # optionally reversing the winding — shortest "pen drag"
        d = np.linalg.norm(p - tail, axis=1)
        k = int(np.argmin(d))
        loop = np.roll(p, -k, axis=0)
        loop = np.concatenate([loop, loop[:1]], axis=0)  # re-close
        chain.append(loop)
    pts = np.concatenate(chain, axis=0)

    # scale to the requested letter height, center at the origin
    span = pts[:, 1].max() - pts[:, 1].min()
    pts = (pts - pts.mean(axis=0)) * (height / span)
    # resample fine -> smooth corners (handwriting-like, see
    # _smooth_polyline) -> resample to the requested count; smoothing
    # shaves the extrema a little, so restore the requested letter height
    pts = _resample_polyline(pts, 4 * n_points)
    pts = _smooth_polyline(pts, smooth_window * 4)
    pts = _resample_polyline(pts, n_points)
    pts = pts * (height / (pts[:, 1].max() - pts[:, 1].min()))

    zeros = np.zeros(len(pts))
    quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (len(pts), 1))
    return {
        "X": zeros.tolist(),
        "Y": pts[:, 0].tolist(), "Z": pts[:, 1].tolist(),
        "quat_X": quat[:, 0].tolist(), "quat_Y": quat[:, 1].tolist(),
        "quat_Z": quat[:, 2].tolist(), "quat_W": quat[:, 3].tolist(),
    }


def write_track(path: str, track: dict | None = None) -> None:
    with open(path, "w") as f:
        json.dump(track or lissajous_track(), f)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out", nargs="?", default="track.json")
    ap.add_argument("--letters", type=str, default=None,
                    help="trace this text instead of the Lissajous figure")
    ap.add_argument("--height", type=float, default=0.25)
    ap.add_argument("--n_points", type=int, default=300)
    args = ap.parse_args()
    trk = (letter_track(args.letters, args.height, args.n_points)
           if args.letters else lissajous_track())
    write_track(args.out, trk)
