"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the closed loop of a fleet of independent robots: each
tick is one ``mpc_step`` for the whole batch, the plant (1 ms RK4
substeps) turns its ``u0`` into the next states, ``u0`` is fed back, and
one ``torch.cuda.synchronize()`` ends the tick, so its host-clock time is
known.  With ``--trace 0`` the window holds nothing else and gives the
end-to-end metrics:

* ``solves_per_s``: lanes x ticks completed in the window over the
  window's seconds;
* ``tick_p95_ms``: the 95th percentile of every tick's host-clock time;
* ``setup_s``: process start to the first timed tick (imports, the CUDA
  context, the kernel library's build or load, the problem, the warm-up
  ticks that carry the cold IPM transients; its split goes to stderr).

With ``--trace 1`` a fixed number of ticks runs under ``torch.profiler``
with the program's phase timer, then a few more under the sync-debug mode,
and the cell's per-layer metrics are read from them (`metrics/*.py`).

The fleet's inputs come from ``--seed`` on the device (a
``torch.Generator``): home + ``perturbation`` N(0, 1) on every state
component, zero inputs, one obstacle per lane as the traffic places it.
Once the window has closed, `check.py` decides ``correct``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import spec

# every build and kernel cache of the run stays inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(spec.ROOT, "build", "portbench", _dir)
# one process, one host thread: the tick's host work is launches
os.environ["OMP_NUM_THREADS"] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "mpcc_manipulator_tpu")
PROGRAM = "mpcc_manipulator_tpu_torch"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores, same sheet


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fleet(side, config: dict, traffic: dict, seed: int):
    """``(x0, u0, obs_pos, obs_radius)`` of the fleet, drawn from ``seed``
    on the side's device."""
    import torch
    dev, dt, batch = side.device, side.dtype, traffic["batch"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (2 ** 63))
    home = torch.tensor(config["x0_home"], dtype=dt, device=dev)
    x0 = home + traffic["perturbation"] * torch.randn(
        batch, home.numel(), generator=gen, dtype=dt, device=dev)
    u0 = torch.zeros(batch, side.system.nu, dtype=dt, device=dev)
    obs = traffic["obstacle"]
    obs_pos = torch.tensor(obs["position"], dtype=dt,
                           device=dev).expand(batch, 3).contiguous()
    obs_radius = torch.full((batch,), float(obs["radius"]), dtype=dt,
                            device=dev)
    return x0, u0, obs_pos, obs_radius


def _work(side, traffic, readings: dict, iters_sum: float) -> dict:
    """Each kernel that ran: device seconds, launches and its bound."""
    out = {}
    for mod in spec.kernels():
        k = readings["kernels"][mod.__name__]
        nbytes, flops = mod.work(side.system, traffic["batch"],
                                 k["launches"], iters_sum)
        out[mod.SYMBOL] = dict(k, bytes=nbytes, flops=flops, bound_s=max(
            nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S))
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
             t_start: float, device="cuda", make_side=None) -> tuple:
    """Run ``cell`` once; ``(result, stderr lines)``.  ``make_side(config,
    traffic, device)`` builds what runs in the window (the program by
    default)."""
    import numpy as np
    import torch

    from . import check, sides, trace

    log = []
    t_import = time.perf_counter()
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        _sync(device)
    t_ctx = time.perf_counter()
    make_side = make_side or sides.Program
    program = isinstance(make_side, type) and issubclass(make_side,
                                                         sides.Program)
    if program:
        torch.backends.cuda.matmul.allow_tf32 = False   # the config's
        torch.backends.cudnn.allow_tf32 = False         # "TF32 off"
    if device.type == "cuda" and program:
        from mpcc_manipulator_tpu_torch.ops import cuda_build
        cuda_build.library()
    t_lib = time.perf_counter()
    config, traffic = cell.config, cell.traffic
    side = make_side(config, traffic, device)
    x, u, obs_pos, obs_radius = fleet(side, config, traffic, seed)
    carry = side.init(traffic["batch"])
    rows, mid = check.sample(seed, traffic["batch"], traffic["check_lanes"],
                             traffic["trace_ticks"] if trace_on
                             else traffic["check_tick_below"])
    _sync(device)
    t_prob = time.perf_counter()

    # warm-up: the cold first tick (kept for the check) and the IPM
    # warm-start transients, every shape the window uses
    snaps = []
    for k in range(traffic["warmup_ticks"]):
        c_in, x_in, u_in = carry, x, u
        carry, out = side.tick(carry, x, u, obs_pos, obs_radius)
        x, u = side.plant(out.x0_updated, out.u0), out.u0
        if k == 0:
            snaps.append(check.Snapshot(c_in, x_in, u_in, out, x))
    _sync(device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    log.append(f"setup split (s): import {t_import - t_start}, cuda_context "
               f"{t_ctx - t_import}, kernel_library {t_lib - t_ctx}, problem "
               f"{t_prob - t_lib}, warmup_ticks {t_warm - t_prob} "
               f"({traffic['warmup_ticks']} ticks); setup_s {setup_s}")

    oks, iters, times = [], [], []
    last = None
    if not trace_on:
        t_w0 = time.perf_counter()
        t1 = t_w0
        while t1 - t_w0 < seconds:
            t0 = time.perf_counter()
            c_in, x_in, u_in = carry, x, u
            carry, out = side.tick(carry, x, u, obs_pos, obs_radius)
            x, u = side.plant(out.x0_updated, out.u0), out.u0
            _sync(device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            oks.append(out.ok)
            last = check.Snapshot(c_in, x_in, u_in, out, x)
            if len(times) - 1 == mid:
                snaps.append(last)
        window_s = t1 - t_w0
    else:
        # the traced window: the device's operations alone, so that the
        # profiler adds as little as it can to the host's launches
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CUDA]
        symbols = {m.__name__: m.SYMBOL for m in spec.kernels()}
        timer = trace.span_timer(device)
        with torch.profiler.profile(activities=acts) as prof:
            t_w0 = time.perf_counter()
            for k in range(traffic["trace_ticks"]):
                c_in, x_in, u_in = carry, x, u
                carry, out = side.tick(carry, x, u, obs_pos, obs_radius,
                                       timer=timer)
                x, u = side.plant(out.x0_updated, out.u0), out.u0
                oks.append(out.ok)
                iters.append(out.qp_iters)
                last = check.Snapshot(c_in, x_in, u_in, out, x)
                if k == mid:
                    snaps.append(last)
                _sync(device)
            window_s = time.perf_counter() - t_w0
        phase_s = timer.times().as_dict()   # seconds by phase
        readings = trace.device_reading(prof, symbols)
        del prof

        # the gap segment: host spans beside the device, to name what the
        # host was doing while the device sat idle
        gap_timer = trace.span_timer(device)
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA]
            if device.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            with trace.span(trace.WINDOW):
                for _ in range(traffic["gap_ticks"]):
                    c_in, x_in, u_in = carry, x, u
                    with trace.span("mpc_step"):
                        carry, out = side.tick(carry, x, u, obs_pos,
                                               obs_radius, timer=gap_timer)
                    with trace.span("plant"):
                        x, u = side.plant(out.x0_updated, out.u0), out.u0
                    with trace.span("record"):
                        last = check.Snapshot(c_in, x_in, u_in, out, x)
                    _sync(device)
        readings["idle_gaps"] = trace.idle_gaps(prof)
        del prof

        def sync_ticks():
            nonlocal carry, x, u
            for _ in range(traffic["sync_ticks"]):
                carry, out = side.tick(carry, x, u, obs_pos, obs_radius)
                x, u = side.plant(out.x0_updated, out.u0), out.u0

        sites = trace.count_syncs(sync_ticks, PROGRAM, device)
        outside = [s for s in sites if s.startswith("outside")]
        sites = [s for s in sites if not s.startswith("outside")]
        log.append(f"host syncs over {traffic['sync_ticks']} ticks: "
                   f"{len(sites)} at {sorted(set(sites))}; not asked for "
                   f"by the program: {outside}")
    if last is not snaps[-1]:
        snaps.append(last)

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    ticks = len(oks)
    attempted = traffic["batch"] * ticks
    failed = int(sum(int((~ok).sum()) for ok in oks))
    if trace_on:
        n_it = torch.stack(iters).double()
        iters_sum, iters_mean = float(n_it.sum()), float(n_it.mean())
    gathered = [check.gather(s, rows, obs_pos, obs_radius) for s in snaps]
    del snaps, last, carry, out, x, u, oks, iters
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window, on the program's outputs alone
    ref = sides.Reference(config, traffic, device)
    numbers = check.compare(ref, gathered)
    correct, compared = check.verdict(numbers, cell.limits)

    metrics = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if not trace_on:
        values = {"solves_per_s": attempted / window_s,
                  "tick_p95_ms": float(np.percentile(times, 95)) * 1e3,
                  "setup_s": setup_s}
        log.append(f"window: {ticks} ticks in {window_s} s; tick ms median "
                   f"{float(np.median(times)) * 1e3}, p95 "
                   f"{values['tick_p95_ms']}, max {max(times) * 1e3}")
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = dict(spans_ms={k: v * 1e3 / ticks for k, v in phase_s.items()},
                   syncs=len(sites), sync_ticks=traffic["sync_ticks"],
                   qp_iters_mean=iters_mean,
                   route="admm" if side.cfg.qp_solver == "admm"
                   else "riccati",
                   kernels=_work(side, traffic, readings, iters_sum),
                   busy_s=readings["busy_s"], window_s=window_s)
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=readings["busy_s"], window_s=window_s)
        result["breakdown"] = {"device_ops": readings["device_ops"],
                               "idle_gaps": readings["idle_gaps"]}
        log.append(f"traced window: {ticks} ticks, busy {readings['busy_s']}"
                   f" s of {window_s} s; kernels "
                   f"{json.dumps(ctx['kernels'])}")
    result["metrics"] = metrics
    result["device"] = dev_info
    result["card"] = card_limits(device)
    result["check"] = compared
    return result, log


def card_limits(device) -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    if device.type != "cuda":
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, log = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    print(f"card: {result['card']}", file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
