"""The RTI-against-converged A/B (`gates.rti_vs_converged`) on several
routes, float32, per lane: where a lane's drift comes from.

    python -m mpcc_manipulator_tpu_torch.probe_ab [--device cuda|cpu]

On :func:`gates.home_states` (8 lanes), 60 ticks, it prints each lane's
largest |dq| and |ds| between the converged and the RTI run on:

* ``kernels``: the bench route (K1-K4 on the card);
* ``plain K2-K4``: the plain assembly, evaluation and kinematics (K1 on
  the card);
* ``plain``: every kernel's plain version (K1's too, swapped in for the
  run), so on the card no hand-written kernel runs;
* ``jax settings``: the JAX test's settings (`gates.JAX_ROUTE`: a cold
  interior point, the finite-difference gradient; K1 on the card).

A lane that drifts on the ``plain`` route too is not moved by a kernel's
rounding.  A check tool: it asserts nothing.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from . import gates, timing
from .solver import qp_ipm_kernel
from .solver import sqp as sqp_mod

PLAIN_K234 = dict(qp_assembly="xla", kin_backend="xla")


@contextlib.contextmanager
def plain_k1():
    """K1's plain version in place of the K1 route for the block's SQP
    iterations."""
    saved = sqp_mod.solve_qp_ipm_k
    sqp_mod.solve_qp_ipm_k = qp_ipm_kernel.solve_qp_ipm_plain
    try:
        yield
    finally:
        sqp_mod.solve_qp_ipm_k = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ticks", type=int, default=60)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(timing.card_line())
    routes = (("kernels", {}, contextlib.nullcontext),
              ("plain K2-K4", PLAIN_K234, contextlib.nullcontext),
              ("plain", PLAIN_K234, plain_k1),
              ("jax settings", gates.JAX_ROUTE, contextlib.nullcontext))
    fmt = lambda a: np.array2string(a, formatter={"float": "{:.3e}".format})
    for name, route, ctx in routes:
        with ctx():
            r = gates.ab_run(torch.float32, dev, gates.LANES, args.ticks,
                             route)
        print(f"{name} ({dev.type}): |dq| {fmt(r['dq'])}; |ds| "
              f"{fmt(r['ds'])}; lanes over {gates.AB_TOL:g}: q "
              f"{np.flatnonzero(r['dq'] >= gates.AB_TOL).tolist()}, s "
              f"{np.flatnonzero(r['ds'] >= gates.AB_TOL).tolist()}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
