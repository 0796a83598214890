"""K1 built from two source trees, compared on one GPU.

    python -m mpcc_manipulator_tpu_torch.compare_k1 --base DIR

``DIR`` holds another tree's kernel sources (the ``csrc/*.cu`` of, for
example, the parent commit, unpacked with ``git archive`` into a git-ignored
directory); its library must take the same C arguments as this tree's.
Both trees build into ``build/torch_kernels/`` (the library name carries a
hash of the sources).  On the StageQPK of the first tick at the perturbed
home states (the Panda at batch 1024, the Husky+Panda at 4096 and 1024):

* every output of the Panda's K1, both schemes, cold and warm, compared
  bit for bit between the two builds, and the Husky+Panda's largest gap
  printed;
* each build's launch configuration at N = 10;
* each warm solve timed with CUDA events, in turns: base, this tree, this
  tree, base.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

from .mpc import _cold_start, _unwrap_s
from .ocp import qp_stages
from .ocp.robot_data import compute_robot_data
from .ocp.qp_data import split_z
from .ops import cuda_build
from .problem import X0_HOME, X0_HOME_MOBILE, build_problem
from .solver.qp_ipm_kernel import (launch_config, solve_qp_ipm_k,
                                   solve_qp_ipm_plain)
from .system import HUSKY_PANDA, PANDA
from .timing import cuda_ms

TS = 0.01
SYMBOLS = ("ipm_kernel",)
FIELDS = ("dx_tilde", "du", "lam", "s_rows", "lam_rows", "iters", "solved",
          "mu")


def stage_qps(system, batch: int, dev):
    """The first tick's StageQPK at ``batch`` home states + 0.01 N(0,1)
    (seed 0), the cold-start horizon, u = 0."""
    track, params, sel_nn, env_nn = build_problem(torch.float32, dev,
                                                  system=system)
    home = X0_HOME if system.base_dof == 0 else X0_HOME_MOBILE
    rng = np.random.default_rng(0)
    x0 = torch.tensor(home[None] + 0.01 * rng.standard_normal(
        (batch, home.size)), dtype=torch.float32, device=dev)
    z = _unwrap_s(_cold_start(x0, system), track.length, system)
    xs, _ = split_z(z, system)
    f32 = dict(dtype=torch.float32, device=dev)
    rb = compute_robot_data(
        xs[..., :system.dof].contiguous(),
        torch.tensor([[3.0, 3.0, 3.0]], **f32).expand(batch, 3),
        torch.zeros(batch, **f32), sel_nn, env_nn, mani_grad="analytic",
        system=system, kin_backend="pallas")
    u0 = torch.zeros(batch, system.nu, **f32)
    return qp_stages.build_qp_stages_k(track, z, rb, params, u0, TS,
                                       system=system)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="directory of the other tree's csrc/*.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k1: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    trees = {"base": args.base, "this": cuda_build._CSRC}
    for name, src in trees.items():
        print(f"{name} ({src}) ptxas:\n"
              f"{cuda_build.use_sources(src, SYMBOLS)}")
        for sy in (PANDA, HUSKY_PANDA):
            print(f"  {name} {sy.name} launch at N = 10: "
                  f"{launch_config(10, sy)}")

    cases = {PANDA.name: (PANDA, stage_qps(PANDA, 1024, dev), (1024,)),
             HUSKY_PANDA.name: (HUSKY_PANDA,
                                stage_qps(HUSKY_PANDA, 4096, dev),
                                (4096, 1024))}
    for label, (sy, qpk, batches) in cases.items():
        for scheme in ("adaptive", "mehrotra"):
            cold_ref = solve_qp_ipm_plain(qpk, system=sy, scheme=scheme)
            ws = torch.clamp(cold_ref.s_rows, 0.1, 100.0)
            wl = torch.clamp(cold_ref.lam_rows, 0.1, 100.0)
            out = {}
            for name, src in trees.items():
                cuda_build.use_sources(src)
                out[name] = (
                    solve_qp_ipm_k(qpk, system=sy, scheme=scheme),
                    solve_qp_ipm_k(qpk, warm_s=ws, warm_lam=wl, system=sy,
                                   scheme=scheme))
                torch.cuda.synchronize()
            for i, start in enumerate(("cold", "warm")):
                a, b = out["base"][i], out["this"][i]
                same = all(torch.equal(getattr(a, f), getattr(b, f))
                           for f in FIELDS)
                gap = max(float((getattr(a, f).float()
                                 - getattr(b, f).float()).abs().max())
                          for f in FIELDS)
                d_it = int((a.iters - b.iters).abs().max())
                print(f"{label} {scheme} {start}: bit-identical {same}; "
                      f"max |diff| {gap:.3e}; iterations differ by at most "
                      f"{d_it}; mean iterations {a.iters.double().mean():.3f}"
                      f" / {b.iters.double().mean():.3f}")
            for batch in batches:
                part = type(qpk)(**{f.name: getattr(qpk, f.name)[:batch]
                                    .contiguous()
                                    for f in dataclasses.fields(qpk)})
                pw, pl = ws[:batch].contiguous(), wl[:batch].contiguous()
                times = []
                for name in ("base", "this", "this", "base"):
                    cuda_build.use_sources(trees[name])
                    times.append((name, cuda_ms(lambda: solve_qp_ipm_k(
                        part, warm_s=pw, warm_lam=pl, system=sy,
                        scheme=scheme), args.reps)))
                print(f"{label} {scheme} warm at batch {batch}, ms: "
                      + ", ".join(f"{n} {t:.4f}" for n, t in times))


if __name__ == "__main__":
    main()
