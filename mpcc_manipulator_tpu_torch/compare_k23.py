"""K2, K3 and K4 built from two source trees, compared on one GPU.

    python -m mpcc_manipulator_tpu_torch.compare_k23 --base DIR

``DIR`` holds another tree's kernel sources (the ``csrc/*.cu`` of, for
example, the parent commit, unpacked with ``git archive`` into a git-ignored
directory); its ``mpcc_assembly``, ``mpcc_eval_point`` and
``mpcc_kin_sweep`` must take the same C arguments as this tree's.  Both
trees build into ``build/torch_kernels/`` (the library name carries a hash
of the sources).  On the first tick's
iterate at the perturbed home states (the Panda at batch 1024, the
Husky+Panda at 4096 and 1024), with 0.02 N(0,1) trial points and five such
candidates a scenario:

* each build's ptxas report on ``assembly_kernel``, ``eval_kernel`` and
  ``kin_kernel``, and this tree's K4 launch (``launch_config``);
* K2's fifteen blocks, base against this tree, block by block: max |d| over
  max(1, max |block|), at the iterate and at the trial point;
* K3's objective and violation at the trial points and the candidates: max
  |d| over max(1, |value|);
* K4's six outputs on the first tick's knots (``k4_inputs``) and on a
  spread draw about home: max |d| over max(1, max |output|), and which are
  bit-identical;
* each kernel's device time (``torch.profiler``), in turns: base, this
  tree, this tree, base;
* with ``--host-base ROOT`` (the root of a whole other tree, for example
  the parent commit's ``git archive`` unpacked into a git-ignored
  directory), its Python wrappers' host microseconds a call against this
  tree's, in turns in one process (that tree's package imported under
  another name).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from .ops import assembly_kernel as ak
from .ops import cuda_build
from .ops import kinematics_kernel as kk
from .system import HUSKY_PANDA, PANDA
from .timing import device_ms, host_us

TS = 0.01
CANDIDATES = 5
SYMBOLS = ("assembly_kernel", "eval_kernel", "kin_kernel")
K4_OUT = ("p_ee", "r_ee", "jv", "jw", "manipul", "d_manipul")


def inputs(system, batch: int, dev, pkg: str = __package__):
    """``(track, params, z, trial z, candidates, current u, RobotData)``:
    the cold-start horizon at ``batch`` home states + 0.01 N(0,1) (seed 0),
    trial points and ``CANDIDATES`` candidates z + 0.02 N(0,1), current u
    0.02 N(0,1) (seed 11), the RobotData of z; made by package ``pkg``'s
    modules (this one's by default)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    mpc, problem = mod("mpc"), mod("problem")
    track, params, sel_nn, env_nn = problem.build_problem(
        torch.float32, dev, system=system)
    f32 = dict(dtype=torch.float32, device=dev)
    home = (problem.X0_HOME if system.base_dof == 0
            else problem.X0_HOME_MOBILE)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(home[None] + 0.01 * rng.standard_normal(
        (batch, home.size)), **f32)
    z = mpc._unwrap_s(mpc._cold_start(x0, system), track.length, system)
    rng = np.random.default_rng(11)
    draw = lambda *shape: torch.tensor(0.02 * rng.standard_normal(shape),
                                       **f32)
    zt = z + draw(*z.shape)
    zc = z[:, None] + draw(batch, CANDIDATES, z.shape[-1])
    cu = draw(batch, system.nu)
    xs, _ = mod("ocp.qp_data").split_z(z, system)
    rb = mod("ocp.robot_data").compute_robot_data(
        xs[..., :system.dof].contiguous(),
        torch.tensor([[3.0, 3.0, 3.0]], **f32).expand(batch, 3),
        torch.zeros(batch, **f32), sel_nn, env_nn, mani_grad="analytic",
        system=system, kin_backend="pallas")
    return track, params, z, zt, zc, cu, rb


def k4_inputs(system, batch: int, dev, pkg: str = __package__) -> dict:
    """K4's configurations (B, 11, dof), float32: ``"main path"``, the
    first tick's knots (the cold-start horizon at ``batch`` home states +
    0.01 N(0,1), seed 0, as :func:`inputs` makes them); ``"spread"``, home +
    0.3 N(0,1) on every joint (seed 1, ``chip_smoke.py``'s draw)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    mpc, problem = mod("mpc"), mod("problem")
    track = problem.build_problem(torch.float32, dev, system=system)[0]
    f32 = dict(dtype=torch.float32, device=dev)
    home = (problem.X0_HOME if system.base_dof == 0
            else problem.X0_HOME_MOBILE)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(home[None] + 0.01 * rng.standard_normal(
        (batch, home.size)), **f32)
    z = mpc._unwrap_s(mpc._cold_start(x0, system), track.length, system)
    xs, _ = mod("ocp.qp_data").split_z(z, system)
    rng = np.random.default_rng(1)
    spread = home[:system.dof] + 0.3 * rng.standard_normal(
        (batch, xs.shape[1], system.dof))
    return {"main path": xs[..., :system.dof].contiguous(),
            "spread": torch.tensor(spread, **f32)}


def load_tree(root: str, alias: str = "base_tree"):
    """The port's package of another whole tree (at ``root``), imported
    under ``alias`` beside this one (its modules import each other
    relatively; its kernels build into that tree's ``build/``)."""
    pkg_dir = os.path.join(root, "mpcc_manipulator_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return alias


def wrapper_calls(pkg: str, system_name: str, batch: int, dev) -> dict:
    """K2, K3 and K4 through package ``pkg``'s wrappers on :func:`inputs`'
    and :func:`k4_inputs`' draws (made with that package's modules)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    sy = mod("system").SYSTEMS[system_name]
    ak_ = mod("ops.assembly_kernel")
    kk_ = mod("ops.kinematics_kernel")
    track, params, z, zt, _, cu, rb = inputs(sy, batch, dev, pkg)
    q = k4_inputs(sy, batch, dev, pkg)["main path"]
    return {"K2": lambda: ak_.build_qp_stages_k_kernel(
                track, z, rb, params, cu, TS, system=sy),
            "K3": lambda: ak_.eval_point_kernel(track, zt, rb, params, cu,
                                                TS, sy),
            "K4": lambda: kk_.kin_sweep(q, sy)}


def host_times(base_root: str, dev, rounds: int = 5) -> None:
    """Each tree's wrappers' host us a call (:func:`timing.host_us` over
    40 calls), in turns base, this, this, base, ``rounds`` times; the
    medians."""
    trees = {"base": load_tree(base_root), "this": __package__}
    for name, batch in ((PANDA.name, 1024), (HUSKY_PANDA.name, 4096)):
        calls = {t: wrapper_calls(pkg, name, batch, dev)
                 for t, pkg in trees.items()}
        for kernel in ("K2", "K3", "K4"):
            runs = {"base": [], "this": []}
            for _ in range(rounds):
                for t in ("base", "this", "this", "base"):
                    runs[t].append(host_us(calls[t][kernel], 40))
            print(f"{name} {kernel} wrapper at batch {batch}, host us a call "
                  f"(median of {2 * rounds} runs in turns): base "
                  f"{statistics.median(runs['base']):.1f}, this "
                  f"{statistics.median(runs['this']):.1f}; runs base "
                  + ", ".join(f"{v:.1f}" for v in runs["base"]) + "; this "
                  + ", ".join(f"{v:.1f}" for v in runs["this"]))


def first(case, b: int):
    """The case's first ``b`` scenarios."""
    track, params, z, zt, zc, cu, rb = case
    return (track, params, z[:b], zt[:b], zc[:b], cu[:b],
            type(rb)(**{f.name: getattr(rb, f.name)[:b]
                        for f in dataclasses.fields(rb)}))


def run(case, system, qs: dict) -> dict:
    """K2 at the iterate and the trial point, K3 at the trial points and
    the candidates, K4 on each of ``qs``."""
    track, params, z, zt, zc, cu, rb = case
    k2 = lambda zz: ak.build_qp_stages_k_kernel(track, zz, rb, params, cu,
                                                TS, system=system)
    k3 = lambda zz: ak.eval_point_kernel(track, zz, rb, params, cu, TS,
                                         system)
    out = {"K2 iterate": k2(z), "K2 trial": k2(zt), "K3 trial": k3(zt),
           f"K3 x{CANDIDATES} candidates": k3(zc),
           **{f"K4 {what}": kk.kin_sweep(q, system)
              for what, q in qs.items()}}
    torch.cuda.synchronize()
    return out


def gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b|, that over max(1, max |a|), bit-identical)."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    scale = max(1.0, float(a.abs().max())) if a.numel() else 1.0
    return d, d / scale, bool(torch.equal(a, b))


def compare(label: str, base: dict, this: dict) -> None:
    for what in base:
        a, b = base[what], this[what]
        if what.startswith("K2"):
            rows = {f.name: gap(getattr(a, f.name), getattr(b, f.name))
                    for f in dataclasses.fields(a)}
        elif what.startswith("K4"):
            rows = {n: gap(x, y) for n, x, y in zip(K4_OUT, a, b)}
        else:
            rows = {"obj": gap(a[0], b[0]), "vio": gap(a[1], b[1])}
        worst = max(rows, key=lambda k: rows[k][1])
        same = [k for k, r in rows.items() if r[2]]
        print(f"{label} {what}: largest gap {worst} {rows[worst][0]:.3e} "
              f"({rows[worst][1]:.3e} of its scale); bit-identical: "
              f"{', '.join(same) or 'none'}")
        for k, (d, rel, _) in rows.items():
            print(f"    {k}: max|d| {d:.3e}, {rel:.3e} of its scale")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="directory of the other tree's csrc/*.cu")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--host-base", metavar="ROOT",
                    help="root of another whole tree: time its wrappers' "
                         "host work against this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_k23: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    trees = {"base": args.base, "this": cuda_build._CSRC}
    for name, src in trees.items():
        print(f"{name} ({src}) ptxas:\n"
              f"{cuda_build.use_sources(src, SYMBOLS)}")
    for sy, batch in ((PANDA, 1024), (HUSKY_PANDA, 4096),
                      (HUSKY_PANDA, 1024)):
        print(f"this K4 launch, {sy.name}, batch {batch}: "
              f"{kk.launch_config(sy, batch * (sy.horizon + 1))}")

    full = {PANDA.name: inputs(PANDA, 1024, dev),
            HUSKY_PANDA.name: inputs(HUSKY_PANDA, 4096, dev)}
    kq = {PANDA.name: k4_inputs(PANDA, 1024, dev),
          HUSKY_PANDA.name: k4_inputs(HUSKY_PANDA, 4096, dev)}
    shapes = [(PANDA, 1024, full[PANDA.name], kq[PANDA.name]),
              (HUSKY_PANDA, 4096, full[HUSKY_PANDA.name],
               kq[HUSKY_PANDA.name]),
              (HUSKY_PANDA, 1024, first(full[HUSKY_PANDA.name], 1024),
               {k: q[:1024].contiguous()
                for k, q in kq[HUSKY_PANDA.name].items()})]
    for sy, batch, case, qs in shapes[:2]:
        out = {}
        for name, src in trees.items():
            cuda_build.use_sources(src)
            out[name] = run(case, sy, qs)
        compare(f"{sy.name} at {batch}", out["base"], out["this"])

    for sy, batch, case, qs in shapes:
        track, params, z, zt, zc, cu, rb = case
        q = qs["main path"]
        calls = {
            "K2": (lambda: ak.build_qp_stages_k_kernel(
                track, z, rb, params, cu, TS, system=sy), "assembly_kernel<"),
            "K3": (lambda: ak.eval_point_kernel(
                track, zt, rb, params, cu, TS, sy), "eval_kernel<"),
            f"K3 x{CANDIDATES}": (lambda: ak.eval_point_kernel(
                track, zc, rb, params, cu, TS, sy), "eval_kernel<"),
            "K4": (lambda: kk.kin_sweep(q, sy), "kin_kernel<")}
        for what, (fn, symbol) in calls.items():
            times = []
            for name in ("base", "this", "this", "base"):
                cuda_build.use_sources(trees[name])
                times.append((name, device_ms(fn, symbol, args.reps)))
            print(f"{sy.name} {what} at batch {batch}, device ms: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in times))

    if args.host_base:
        cuda_build.use_sources(trees["this"])
        host_times(args.host_base, dev)


if __name__ == "__main__":
    main()
