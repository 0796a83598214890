"""Per-layer profile of the batched closed-loop tick on one GPU.

    python -m mpcc_manipulator_tpu_torch.profile_tick [--batch 1024]
        [--system panda|husky_panda]

For the Panda (the default ``--system``): for the default configuration (RTI, the Riccati path), its converged mode,
the Riccati RTI path with Mehrotra's centering in K1 (the JAX bench's
``MPCC_IPM_SCHEME=mehrotra``) and the dense ADMM path under RTI (the JAX
bench's ``MPCC_QP_SOLVER=admm MPCC_QP_BACKEND=pallas`` ablation), each
layer of the tick is timed on the host clock with a
``torch.cuda.synchronize()`` before and after it (which slows the tick),
summed over ``--ticks`` ticks after ``--warmup`` ticks, and printed per
tick, with the mean QP iterations per lane-tick; on the ADMM path also the mean ADMM iterations a
lane runs in each K5 launch, for the phase-1 and phase-2 launches of the QP
solve apart (their ``max_iter`` budgets, ``qp_check_every`` and the rest
of ``qp_max_iter``, tell them apart), which sets K5's time per tick against
its bound.  Then ``torch.profiler`` traces three unwrapped ticks of each
RTI path and prints the device time and the number of device kernels,
counted from the device-side kernel events only (each aten operator's row
also carries the device time of the kernels it launched, so a sum over all
rows counts that time twice).  For the Husky+Panda (``--system
husky_panda``) the same for its one path, the default configuration (RTI,
K1-K4; the dense ADMM path is Panda-only).
"""

from __future__ import annotations

import argparse
import collections
import functools
import statistics
import subprocess
import time

import numpy as np
import torch

from . import mpc as mpc_mod
from .models.dynamics import sim_time_step
from .ocp import qp_data
from .ops import admm_kernel
from .ops import assembly_kernel as ak
from .params import SQPConfig
from .problem import X0_HOME, X0_HOME_MOBILE, build_problem
from .solver import qp_admm
from .solver import sqp as sqp_mod
from .system import PANDA, SYSTEMS

TS = 0.01
MEHROTRA_RTI = SQPConfig(ipm_scheme="mehrotra")
ADMM_RTI = SQPConfig(qp_solver="admm", qp_backend="pallas",
                     qp_assembly="xla", qp_max_iter=200, qp_check_every=25)

# (label, module, attribute) of each timed layer
LAYERS = [
    ("projection", mpc_mod.als, "project_on_spline"),
    ("RobotData (K4 + NN)", mpc_mod, "compute_robot_data"),
    ("assembly (K2 + shared blocks)", ak, "build_qp_stages_k_kernel"),
    ("line-search eval (K3)", ak, "eval_point_kernel"),
    ("IPM solve (K1 + warm-start repack)", sqp_mod, "solve_qp_ipm_k"),
    ("dense QP assembly (build_qp)", qp_data, "build_qp"),
    ("Hessian guard (jittered Cholesky)", sqp_mod, "_hessian_guard"),
    ("ADMM QP solve total (solve_qp)", qp_admm, "solve_qp"),
    ("- Ruiz equilibration", qp_admm, "_ruiz_equilibrate"),
    ("- K^-1 factorizations (2 per solve)", qp_admm, "_factor"),
    ("- K5 ADMM loop (2 launches per solve)", admm_kernel, "fused_admm"),
    ("line-search eval (plain)", ak, "eval_point_plain"),
    ("solve_ocp total", sqp_mod, "solve_ocp"),
]


def _wrap(label, fn, acc):
    # wraps() copies the kernel wrappers' launch counters, which they
    # update through their module-level name while the wrapper stands in
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[label] += time.perf_counter() - t0
        return out
    return timed


def _count_iters(fn, rec):
    """``fn`` (fused_admm) recording each launch's mean iterations per
    lane under its ``max_iter`` budget."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        rec[kwargs["max_iter"]].append(float(out[3].double().mean()))
        return out
    return counted


def _start(batch, dev, system=PANDA):
    x_home = X0_HOME if system.base_dof == 0 else X0_HOME_MOBILE
    rng = np.random.default_rng(0)
    x = torch.tensor(x_home[None]
                     + 0.01 * rng.standard_normal((batch, system.nx)),
                     dtype=torch.float32, device=dev)
    u = torch.zeros(batch, system.nu, device=dev)
    carry = mpc_mod.init_carry(batch, torch.float32, dev, system)
    obs = torch.tensor([[3.0, 3.0, 3.0]], device=dev).expand(batch, 3)
    return x, u, carry, obs, torch.zeros(batch, device=dev)


def _ticks(problem, state, n, cfg, system=PANDA):
    x, u, carry, obs, rad = state
    for _ in range(n):
        carry, out = mpc_mod.mpc_step(*problem, carry, x, u, obs, rad, ts=TS,
                                      cfg=cfg, system=system)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
    return (x, u, carry, obs, rad), out


def layer_profile(problem, batch, dev, cfg, warmup, ticks, system=PANDA):
    """(median wrapped tick s, mean SQP iterations, mean QP iterations per
    lane-tick, {layer: s per tick}, {K5 max_iter budget: mean iterations
    per lane of each launch})."""
    acc = collections.defaultdict(float)
    k5_iters = collections.defaultdict(list)
    saved = [(mod, name, getattr(mod, name)) for _, mod, name in LAYERS]
    state, _ = _ticks(problem, _start(batch, dev, system), warmup, cfg,
                      system)
    times, iters, qp_iters = [], [], []
    try:
        for label, mod, name in LAYERS:
            setattr(mod, name, _wrap(label, getattr(mod, name), acc))
        admm_kernel.fused_admm = _count_iters(admm_kernel.fused_admm,
                                              k5_iters)
        for _ in range(ticks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = _ticks(problem, state, 1, cfg, system)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            iters.append(float(out.sqp_iters.float().mean()))
            qp_iters.append(float(out.qp_iters.float().mean()))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return (statistics.median(times), float(np.mean(iters)),
            float(np.mean(qp_iters)),
            {k: v / ticks for k, v in acc.items()}, k5_iters)


def device_profile(problem, batch, dev, cfg, warmup, ticks=3,
                   system=PANDA):
    """(device kernel s, kernels launched, profiled wall s, median
    unprofiled tick s) over ``ticks`` ticks of ``cfg``, the first three
    from the profiler's device-side kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    state, _ = _ticks(problem, _start(batch, dev, system), warmup, cfg,
                      system)
    plain = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = _ticks(problem, state, 1, cfg, system)
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _ticks(problem, state, ticks, cfg, system)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    return busy_us * 1e-6, len(kernels), wall, statistics.median(plain), prof


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--system", choices=sorted(SYSTEMS), default="panda")
    args = ap.parse_args()
    system = SYSTEMS[args.system]
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    problem = build_problem(torch.float32, dev, system=system)
    paths = [("RTI (default)", SQPConfig())]
    if system.base_dof == 0:
        paths += [("converged", SQPConfig(rti=False, max_iter=20)),
                  ("Mehrotra RTI", MEHROTRA_RTI),
                  ("ADMM RTI (K4 + K5)", ADMM_RTI)]
    for label, cfg in paths:
        med, iters, qp_iters, layers, k5_iters = layer_profile(
            problem, args.batch, dev, cfg, args.warmup, args.ticks, system)
        print(f"== {system.name} {label}, batch {args.batch}: wrapped tick "
              f"median {med * 1e3:.3f} ms, mean SQP iterations {iters:.3f}, "
              f"mean QP iterations per lane-tick {qp_iters:.3f}")
        for k, v in sorted(layers.items(), key=lambda kv: -kv[1]):
            print(f"   {k}: {v * 1e3:.3f} ms/tick")
        # phase 1 runs qp_check_every iterations, phase 2 the rest (175
        # of the 200 here), so the smaller budget is phase 1's
        for phase, (budget, runs) in enumerate(sorted(k5_iters.items())):
            print(f"   K5 phase {phase + 1} launches (max_iter {budget}): "
                  f"{len(runs)}, mean ADMM iterations per lane "
                  f"{np.mean(runs):.2f} (min {min(runs):.2f}, max "
                  f"{max(runs):.2f})")
    traced = [("RTI", SQPConfig())]
    if system.base_dof == 0:
        traced += [("Mehrotra RTI", MEHROTRA_RTI), ("ADMM RTI", ADMM_RTI)]
    for label, cfg in traced:
        busy, n_kernels, wall, tick, prof = device_profile(
            problem, args.batch, dev, cfg, args.warmup, system=system)
        print(f"profiler, 3 {system.name} {label} ticks, batch {args.batch}: "
              f"device kernel time "
              f"{busy * 1e3:.3f} ms in {wall * 1e3:.1f} ms wall (profiled); "
              f"{n_kernels} device kernels, {n_kernels / 3:.0f} per tick; "
              f"unprofiled tick median {tick * 1e3:.3f} ms, device busy "
              f"{busy / 3 / tick:.1%} of it")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=12))


if __name__ == "__main__":
    main()
