"""Drive the PyTorch + CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

Phases (the first failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA device -> fail;
2. build the CUDA kernels from ``mpcc_manipulator_tpu_torch/csrc`` (one
   nvcc per source, all at once);
3. K4 (kinematics sweep) against its plain PyTorch version at (1024, 11, 7),
   and a NaN in three configurations' q: NaN in their outputs, every other
   configuration bit-identical;
4. K1 (interior-point QP solve, one warp per scenario): its launch
   configuration, one kernel for both centering schemes (held: 8 blocks an
   SM, no local memory, one wave at batch 1024), then against its plain
   version on the StageQPK of 1024 perturbed home states, adaptive and
   Mehrotra, cold and warm started; a
   NaN in one lane's Hessian leaves that lane not solved and the other lanes
   bit-identical; each scheme's warm launch timed;
5. K2 (stage-QP assembly) against its plain version at 1024 lanes, every
   block: on the main path's track at the first tick's iterate and at a
   0.02-perturbed trial point, then in the three regions of the JAX kernel
   test (interior, endpoint and taper, obstacle near with the weight
   scheduling firing), then at horizons N = 5 and N = 20; NaN iterates
   propagating as in the plain version;
6. K3 (line-search evaluation) against its plain version at 1024 lanes at
   0.02-perturbed iterates, one candidate and five candidates per lane, on
   the main path's track, in the three regions and at N = 5 and N = 20;
7. K5 (the fused ADMM loop, one thread block cluster per scenario): its
   launch configuration, then against its plain version:
   the JAX kernel test's random QPs (n=40, m=70) at batch 256, tiny QPs
   (n=6, m=3) and ragged ones (n=41, m=73) at every cluster size, its
   MPCC-sized QP, and the dense QPs (``build_qp`` -> Ruiz -> K^-1) of the
   first tick at the 1024 perturbed home states, cold and warm; a NaN lane
   runs to its budget, comes out NaN and leaves the other lanes
   bit-identical;
7a. K6 (the tick's projection, one thread a lane): its launch for both
   systems in float32 and float64 at the benchmark cells' batches, 32,768
   and 4,096 (held: at least one block an SM, no local memory beyond the
   trig functions' slow path, 40 B), then against its plain version on
   the bench's draw with s spread over the track and 0.3 past its ends on
   every fourth lane: the Panda in float32 bit for bit, the rest with the
   same jump test, s within 1e-5 and vs within 1e-5 of its terms' scale;
   timed in float32 at both batches for both systems.  Every ``mpc_step``
   on the card launches K6 once, and the launch counts below hold it
   beside K1-K5;
7b. K7 (the collision networks' forward pass and input Jacobian, one
   launch a network): its layout and launch for both networks in float32
   and float64 (held: at least one block an SM; in float32 no local memory
   beyond the trig functions' slow path, 40 B), then against its plain
   version (the cuBLAS route) on the three benchmark cells' knots (home +
   0.01 N(0, 1), a NaN lane) and at batch 1: float32 bit for bit from
   5,632 knots on, NaN where NaN, the rest within 2e-6 (float32) or 1e-14
   (float64) of each output's scale, the ``nn_units_active`` counts equal;
   timed in float32 at the cells' batches beside the plain route and its
   cuBLAS products (``library_ms``), with the dense and the walked
   operation counts and their bounds; then 60 closed-loop ticks of each
   cell's draw with every tick's NN half held bit for bit against the
   plain route.  Every ``mpc_step`` on the card launches K7 twice (once a
   network) unless ``ipm_interpret=True`` or ``nn_bf16`` names the plain
   route;
8. the kernels' Husky+Panda instantiations (the 10-DOF mobile manipulator,
   BASELINE config 5): K1's launch configuration at N = 5, 10 and 20 for
   both systems (shared bytes, registers, local bytes, blocks an SM, waves
   at the batches run; printed), K2's and K3's there too (held: the card's
   report equal to `ops/assembly_kernel.launch_geometry`, no local memory,
   at most 48 KB of shared memory), K1-h's at N = 10 held to the budget (at
   most 28,160 B of shared memory, 8 blocks an SM, no local memory), K1 in
   both schemes, cold and warm, against its plain version on the StageQPK
   of 4096 perturbed
   mobile home states (iterations within +-1, identical verdicts, steps
   within 1e-3), and a NaN lane; K2 and K3 at 4096 lanes on the mobile
   track (the first tick's iterate, 0.02-perturbed trial points, one and
   five candidates, each cost term alone; at 1024 lanes also at N = 5 and
   N = 20); K4 at (4096, 11, 10), with the NaN check, and K4's launch for
   both systems at the batches run (held: the card's report equal to
   `ops/kinematics_kernel.launch_geometry`, no local memory, at most 48 KB
   of shared memory, at least one block an SM at batch 1024); each timed
   at batch 4096 and 1024;
9. the Husky+Panda RTI path (``mpc_step(system=HUSKY_PANDA)``, K1-K4):
   4096 and then 1024 scenarios x 20 ticks + the plant step; every lane ok
   every tick, finite states, s rising after the start transient, the mean
   base x growing, each kernel launched once per tick; the median and p99
   tick;
10. the Riccati path, the default configuration (RTI, K1-K4): 1024
   scenarios x 30 ticks of ``mpc_step`` + the plant step; every lane ok
   every tick, finite states, s strictly increasing once the start
   transient has passed, and each kernel launched once per tick;
11. the converged mode (``rti=False, max_iter=20``): 1024 x 10 ticks, then 3
   ticks each with the second-order correction and with the merit line
   search; every lane ok, and each kernel launched as often as the SQP
   iterations run call for;
12. the Riccati path under RTI with Mehrotra's centering
    (``ipm_scheme="mehrotra"``): 1024 x 10 ticks, every lane ok, K1
    launched once per SQP iteration and K2-K4 once per tick;
13. the dense ADMM path under RTI (the JAX bench's ``MPCC_QP_SOLVER=admm
    MPCC_QP_BACKEND=pallas`` ablation, ``qp_max_iter=200``): 1024 x 10
    ticks, every lane ok, K5 launched twice per tick and K4 once, K1-K3
    never; then the converged ADMM mode (``rti=False, max_iter=20,
    qp_max_iter=400``) 3 ticks each plain, with BFGS, SOC and the merit
    line search, K5 launched twice per SQP iteration (four times with SOC);
14. 8 lanes through the plain path on the CPU in float64, held to the
    repo's closed-loop envelope: the RTI loop closed loop (10 ticks), the
    Mehrotra RTI loop tick by tick from the GPU run's inputs (10 ticks; the
    closed-loop gap printed), the converged loop tick by tick from the GPU
    run's inputs (5 ticks), and the ADMM RTI loop tick by tick from the
    GPU run's inputs (10 ticks, the plain ``"xla"`` ADMM route; the float32
    plain K5 route's gap to it is printed beside); and every K1 solve of the
    Mehrotra RTI loop (1024 lanes x 10 ticks), the kernel's and the plain
    version's float32 solve on the card, against float64: the kernel no
    further from it than twice the plain solve, in split Newton counts and
    in |d du|; and the Husky+Panda RTI loop tick by tick from the GPU run's
    inputs (20 ticks, q over all 10 joints).
15. every path at N = 5 and N = 20 (both systems, batch 1024): K1 against
    its plain version in both schemes, cold and warm, at K1's tolerances
    (its warm adaptive solve timed), then 10 RTI ticks of ``mpc_step`` at
    that N (K1-K4 once a tick), 8 lanes tick by tick in float64 on the CPU;
16. the plain RobotData route (``kin_backend="xla"``) on the card in
    float64 with ``mani_grad`` fd and ad against K4 on the main path's
    first-tick knots at K4's contract, then 10 RTI ticks with
    ``kin_backend="xla", mani_grad="fd"`` (K1-K3 once a tick, K4 never);
17. ``sim.closed_loop_scan`` at batch 1024, 10 ticks (K1-K4 once a tick),
    bit-identical to the same ticks through ``mpc_step``; its ticks/s;
18. the reference surface ``api.MPCC`` at batch 1, the verify recipe (30
    ticks from home on the repo's track): in JAX's default configuration
    (the converged dense ADMM path with the plain loop, the plain
    kinematics with the finite-difference gradient, float64: K6 alone),
    and in float32 with ``sqp_cfg = SQPConfig()`` (K1-K4 and K6 once a
    tick);
    every tick ok, s strictly increasing, each tick held against
    ``MPCC(device="cpu")`` in float64 from the card's state, input and
    carry (the envelope; the largest gap printed); the tick's median and
    p99 against Ts; then 10 ticks with ``runMPC(profile=True)``, the phase
    split printed;
19. the runtime layer: the native telemetry library built into
    ``build/native/`` and loaded (no fallback); a checkpoint resume at
    batch 1024 with K1-K4 (6 ticks, save, 3 ticks against restore + 3
    ticks, every leaf bit-identical; save and restore timed); the
    ``IsaacBridge`` over the loopback plant, 12 ticks, with the JointState
    contract; ``main_demo.main()`` and ``main_obstacle_demo.main()`` in
    float32, 50 ticks each with
    ``--device cuda`` into a temporary directory, their files' lines and
    columns checked, their tick median and p99;
20. the JAX package's closed-loop gates in float32 on K1-K4, 8 lanes (the
    exact home state, 7 at 1e-3 N(0, 1) on the joints), through
    `mpcc_manipulator_tpu_torch/gates.py` with the JAX tests' thresholds:
    the repo's track to the end point (converged, 3,000-tick budget), the
    static obstacle (margin, CBF contract, the constraint's bite), the
    config ladder, RTI against the converged mode (60 ticks);
21. the scenario split (`parallel/sharding.py`): over NCCL at world size
    1, 5 RTI ticks of the sharded step bit-identical to ``mpc_step`` (the
    Panda at 1024, the Husky+Panda at 4096; K1-K4 once a tick), the fleet
    diagnostics through NCCL equal to the local means, both paths' median
    tick; then the Panda's 1024 lanes split over two spawned processes on
    the one card over gloo (512 a rank, 5 RTI ticks) against the
    unsharded ticks: every lane ok and inside the RTI envelope, the
    bit-identical lanes counted, the fleet diagnostics over gloo on CUDA
    tensors exact;
22. the routes (``SQPConfig`` settings beside the bench's): the packed
    ``qp_solver="riccati"`` and ``"riccati_struct"`` routes (plain stage
    QP and IPM, K4 kinematics) for the Panda at 1024 and the Husky+Panda
    at 4096, 5 RTI ticks each beside the bench route's (K1-K4), every lane
    ok, K4 alone launched on the plain routes, each route's median tick;
    on the first tick's QPs the packed solve, the structured one and K1
    agree (Newton iterations within 1, steps within 5e-4); fleet mode on
    the bench configuration (Panda/1024, the converged mode,
    ``max_iter=5``, 3 ticks) bit-identical to the early-exit loop with
    K1-K3 launched ``max_iter`` times a tick, and the device-to-host syncs
    of one ``solve_ocp`` in each mode (``torch.cuda.set_sync_debug_mode``),
    on the bench route and the packed one: none from `solver/sqp.py` or
    `solver/qp_ipm.py` in fleet mode; the bf16 NN GEMMs (``nn_bf16``) on
    the bench configuration (Panda/1024, 10 RTI ticks): every lane ok,
    |dq| against the float32 GEMMs' run below 2e-4 on the lanes whose
    Newton counts stay the float32 run's, inside the RTI envelope on those
    where the bf16 perturbation moves the IPM's stop test (JAX drifts the
    same way there), the NN half's device ms both ways;
23. the surface (the JAX package's names the port gained last):
    ``import mpcc_manipulator_tpu_torch as M`` and one ``M.MPCC()`` tick
    at batch 1 (JAX's default configuration: K6 alone) held to
    ``M.MPCC(device="cpu")``; ``kinematics_mobile.manipulability_gradient``
    (the Husky+Panda's 10-DoF one) in float64 at 64 configurations within
    1e-9 of the CPU's; the collision nets' unencoded Jacobian
    (``mlp_forward_jacobian(..., is_nerf=False)``) in float64 within 1e-10
    of the CPU's, and RobotData's bf16 GEMMs (``nn_bf16``) in float32
    within 2^-9 of each block's scale of the CPU's, and not equal to the
    float32 GEMMs';
24. JAX's interpret switches, as routes named to each kernel's plain
    version (`ops/cuda_build.kernel_route`): the bench configuration at
    ``ipm_interpret`` None, True and False, 3 RTI ticks each at Panda/1024
    and Husky+Panda/4096: K1-K4 and K6 launched once a tick (K7 twice)
    under None and False, never under True; False bit-identical to None; True's states within
    the closed-loop envelope of None's; the ADMM RTI path with
    ``qp_backend="pallas_interpret"`` against ``"pallas"`` (1024 x 3): K5
    launched twice a tick under ``"pallas"``, never under
    ``"pallas_interpret"``, states within the envelope; then
    ``compute_robot_data`` with JAX's defaults (fd, plain kinematics) in
    float64 on the card against the CPU, both systems at (1024, 11) knots,
    within 1e-10 of each field's scale, of the kernels only K7 launched
    (once a network).

Every phase's seconds are printed as it ends.

Each kernel is timed three ways: its own device time (``torch.profiler``'s
events of its symbol; ``ms`` and ``device_ms``), the wrapper's time (CUDA
events around back-to-back calls; ``wrapper_ms``) and the wrapper's host
microseconds per call (``host_us``).  Then the command time and the card.
The line before last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

BATCH = 1024
TICKS = 30
TS = 0.01
SEED = 0
CHECK_LANES = 8
KNOTS = 11             # N + 1 at the Panda's horizon N = 10
CHECK_TICKS = 10
S_RISING_FROM = 15     # tick from which s must rise on every lane
K4_SINGULAR_BELOW = 0.01   # the controller's singularity buffer (tol_sing)
K1_LAM_WELL_POSED = 100.0  # duals above sit on the clamped s-row margin
K1_NAN_LANE = 5
# the Panda K1 warm solves' times before the per-system instantiation
# (H100 80GB HBM3, 700 W; PERF.md section 6)
K1_PR5_MS = {"adaptive": 0.5503, "mehrotra": 0.9512}
# K2 / K3: the JAX kernel tests' float32 contract
# (tests/test_pallas_assembly.py: 5e-4 x max(1, max|block|); rtol = atol)
K23_TOL = 5e-4
CANDIDATES = 5         # the merit line search's step lengths
COST_WEIGHTS = ("q_c", "q_l", "q_vs", "q_ori", "q_sing", "r_dq", "r_ddq",
                "r_dVs")
# NaN iterates: (lane, index in z) -- s of knot 4, and dq_3 of u_6
NAN_ENTRIES = [(17, 4 * 9 + 7), (33, 11 * 9 + 6 * 8 + 2)]
CONVERGED = dict(rti=False, max_iter=20)   # the bench's MPCC_RTI=0 run
CONV_TICKS = 10
OPTION_TICKS = 3
CONV_CHECK_TICKS = 5
# closed-loop envelope of the repo (tests/test_rti.py: RTI vs the oracle)
ENVELOPE = {"q": 7.5e-4, "s": 2.5e-4, "vs": 4e-3}
# the dense ADMM path: the JAX bench's ablation (bench.py, MPCC_QP_SOLVER=
# admm MPCC_QP_BACKEND=pallas), and its converged mode (api.MPCC)
ADMM_RTI = dict(qp_solver="admm", qp_backend="pallas", qp_assembly="xla",
                qp_max_iter=200, qp_check_every=25)
ADMM_CONVERGED = dict(ADMM_RTI, rti=False, max_iter=20, qp_max_iter=400)
ADMM_TICKS = 10
# the Riccati path with Mehrotra's centering (the JAX bench's
# MPCC_IPM_SCHEME=mehrotra ablation, its round-3 default)
MEHROTRA_RTI = dict(ipm_scheme="mehrotra")
MEHROTRA_TICKS = 10
# the kernel against float64 on the Mehrotra loop's QPs: at most this many
# times the plain float32 solve's split Newton counts and largest |d du|
MEHROTRA_SPLIT_RATIO = 2
# the Husky+Panda path (BASELINE config 5): the JAX bench's batch 4096
# (`bench.py:384`) and its matched point 1024 (`bench.py:400-416`)
MOBILE_BATCHES = (4096, 1024)
MOBILE_TICKS = 20
# tick from which s must rise on every mobile lane: before it the
# projection may still move s back on some lanes while contouring pulls the
# perturbed starts onto the track (the run prints the count per tick)
MOBILE_S_RISING_FROM = 17
# K1-h against its plain version: tests/test_qp_ipm_pallas_mobile.py's
# contract (iterations within +-1, identical verdicts, steps within 1e-3)
MOBILE_IPM_TOL = 1e-3
# the budget K1 is written to at N = 10, for both systems (csrc/qp_ipm.cu):
# 8 blocks an SM (28,160 B of shared memory a block) and no local memory
K1_BLOCKS_PER_SM = 8
K1_SMEM_BUDGET = 28160
# K1's stop test: mu below EPS_IPM (and the row residual below 2e-4)
K1_EPS_IPM = 1e-5
# K1's launch is printed at these horizons (ROADMAP item 13)
K1_HORIZONS = (5, 10, 20)
# the K1-h warm solves' times before its redesign for its dims, at batch
# 4096 / 1024 (H100 80GB HBM3, 700 W; PERF.md section 6)
K1H_BEFORE_MS = {"adaptive": (6.1284, 1.6439), "mehrotra": (4.2692, 1.8581)}
K5_RANDOM_BATCH = 256
K5_NAN_LANE = 5
# K5 against its plain version: the JAX kernel test's contract
# (tests/test_pallas_admm.py): x within 5e-3 on random QPs, 1e-2 on the
# MPCC-sized one (and the main path's), residuals below 1e-3 / 1e-2
K5_X_TOL = {"random": 5e-3, "mpcc_sized": 1e-2, "main path": 1e-2}
K5_RES = (1e-3, 1e-2)
# K5 is held on these QPs at the cluster size fused_admm picks (0: 4 at
# the MPCC size, 1 for the small ones) and at the sizes listed beside it:
# there the tiny QPs (m = 3) leave blocks with no rows (and, at 8, no
# columns of K^-1), and the ragged ones a ragged edge on every block.
K5_CLUSTERS = {"random": (0, 4), "tiny": (0, 2, 4, 8), "ragged": (0, 2, 4, 8),
               "mpcc_sized": (0, 8)}
K5_ALT_CLUSTER = 8     # the other cluster size that holds the MPCC size
# the reference surface (api.MPCC) at batch 1: the verify recipe's ticks,
# then ticks with runMPC(profile=True)
API_TICKS = 30
API_PROFILE_TICKS = 10
# every path at these horizons besides N = 10 (ROADMAP item 13): K1 against
# its plain version and RTI ticks, both systems
HORIZONS = (5, 20)
HORIZON_BATCH = 1024
HORIZON_TICKS = 5
# the lanes of each K1 batch there solved again in float64 on the CPU for
# the printed F1 gaps (the lane where the kernel and the plain solve differ
# most always among them)
F64_GAP_LANES = 256
# the plain kinematics route's RTI loop, and closed_loop_scan's ticks
PLAIN_KIN_TICKS = 10
SCAN_TICKS = 10
# the runtime layer: a checkpoint resume at BATCH (ticks before the save,
# ticks after it), the simulator bridge's ticks, the demos' runs
CKPT_TICKS = 6
CKPT_RESUME = 3
BRIDGE_TICKS = 12
DEMO_TICKS = 50
OBSTACLE_DEMO_TICKS = 50
# the closed-loop gates run on the card, each with its runner's arguments
# (the static gate without its constraint-disabled run; the rest, and the
# disabled run: python -m mpcc_manipulator_tpu_torch.gates)
CARD_GATES = (("track", {}), ("static", {"disabled": False}),
              ("ladder", {}), ("rti_ab", {}))
# the scenario split (`parallel/sharding.py`): RTI ticks through the
# sharded step at world size 1 over NCCL (the Panda at BATCH, the
# Husky+Panda at MOBILE_BATCHES[0]), then the Panda's BATCH split over
# GLOO_RANKS processes on the one card; a rank's result waits at most
# GLOO_TIMEOUT s
SHARDED_TICKS = 5
GLOO_RANKS = 2
GLOO_TIMEOUT = 300
# the surface phase: configurations of the 10-DoF gradient, and lanes of
# RobotData's knots (the Panda's N + 1 each) through the collision nets
SURFACE_CONFIGS = 64
SURFACE_LANES = 64
SURFACE_GRAD_TOL = 1e-9       # absolute: the base columns are rounding
SURFACE_JAC_TOL = 1e-10       # of the Jacobian's scale, float64
SURFACE_BF16_TOL = 2.0 ** -9  # of each block's scale (bf16's roundoff)
# the card's published peaks (NVIDIA's H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def cuda_time(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls after
    one warm-up call."""
    from mpcc_manipulator_tpu_torch.timing import cuda_ms
    return cuda_ms(fn, reps)


def kernel_times(fn, symbol: str, reps: int) -> dict:
    """A wrapper's times: its kernel's own device ms (``ms`` and
    ``device_ms``), the wrapper's ms (CUDA events around ``reps``
    back-to-back calls) and its host us per call."""
    from mpcc_manipulator_tpu_torch.timing import device_ms, host_us
    dev_ms = device_ms(fn, symbol, reps)
    return {"ms": dev_ms, "device_ms": dev_ms,
            "wrapper_ms": cuda_time(fn, reps), "host_us": host_us(fn)}


def times_text(t: dict) -> str:
    return (f"device {t['device_ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} "
            f"ms, host {t['host_us']:.1f} us/call")


def check_close(name, got, ref, atol, rtol=0.0) -> float:
    err = (got - ref).abs()
    bound = atol + rtol * ref.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(
            f"{name}: max |err| {float(err.max()):.3e} exceeds atol {atol} "
            f"rtol {rtol}")
    return float(err.max()) if err.numel() else 0.0


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_wrappers() -> dict:
    from mpcc_manipulator_tpu_torch.solver.sqp_debug import KERNEL_WRAPPERS
    return dict(KERNEL_WRAPPERS)


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def home(system=None) -> np.ndarray:
    """The system's home state (the Panda's when ``system`` is None)."""
    from mpcc_manipulator_tpu_torch import problem
    mobile = system is not None and system.base_dof != 0
    return problem.X0_HOME_MOBILE if mobile else problem.X0_HOME


def perturbed_states(batch: int, dtype, device, system=None) -> torch.Tensor:
    """The home state + 0.01 N(0, 1) on every component (the JAX bench's
    draw, `bench.py:163-165`)."""
    x_home = home(system)
    rng = np.random.default_rng(SEED)
    x0 = x_home[None] + 0.01 * rng.standard_normal((batch, x_home.size))
    return torch.tensor(x0, dtype=dtype, device=device)


def check_k4(label, got, ref) -> tuple:
    """K4's outputs against its plain version's.  The JAX kernel test's f32
    contract, held on every configuration outside the controller's
    singularity buffer (m >= tol_sing = 0.01).  Closer to a singularity
    det(J J') cancels in float32: there the plain version itself is off its
    float64 value by up to 3.7e-6 in m and 1.6e-2 in dm (measured on the
    CPU at the Panda's inputs), so two float32 computations cannot meet the
    contract; they are checked for finiteness and their gap is returned.
    Returns (max error, configurations held, the other ones' m / dm gaps)."""
    well = ref[4] >= K4_SINGULAR_BELOW
    names = ["p_ee", "r_ee", "jv", "jw", "manipul", "d_manipul"]
    tol = [(2e-6, 0.0)] * 4 + [(1e-6, 2e-5), (2e-4, 2e-3)]
    err = max(check_close(f"{label} {n}", g[well], r[well], a, rt)
              for n, g, r, (a, rt) in zip(names, got, ref, tol))
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{label}: non-finite output")
    near = [float((g[~well] - r[~well]).abs().max()) if bool((~well).any())
            else 0.0 for g, r in zip(got[4:], ref[4:])]
    return err, int(well.sum()), int((~well).sum()), near


def phase_k4(device) -> dict:
    from mpcc_manipulator_tpu_torch.ops.kinematics_kernel import (
        kin_sweep, kin_sweep_plain)
    from mpcc_manipulator_tpu_torch.problem import X0_HOME
    rng = np.random.default_rng(SEED + 1)
    qs = torch.tensor(X0_HOME[:7] + 0.3 * rng.standard_normal((BATCH, 11, 7)),
                      dtype=torch.float32, device=device)
    got = kin_sweep(qs)
    ref = kin_sweep_plain(qs)
    torch.cuda.synchronize()
    err, n_well, n_near, near = check_k4("K4", got, ref)
    check_k4_nan("K4", qs)
    t = kernel_times(lambda: kin_sweep(qs), "kin_kernel<", 50)
    plain_ms = cuda_time(lambda: kin_sweep_plain(qs), 20)
    print(f"K4 vs plain at {tuple(qs.shape)}: max|err| {err:.3e} on "
          f"{n_well} configurations; {n_near} with "
          f"m < {K4_SINGULAR_BELOW}: max|err| m {near[0]:.3e}, dm "
          f"{near[1]:.3e}; {times_text(t)}, plain {plain_ms:.4f} ms")
    # bytes: the configurations in, the six outputs out; operations:
    # k4_flops a configuration
    return {"name": "K4 kinematics sweep (kin_sweep)", "route": "cuda",
            "source": "mpcc_manipulator_tpu_torch/csrc/kinematics.cu",
            "replaces": "mpcc_manipulator_tpu/ops/pallas_kinematics.py:228",
            "max_abs_err": err, **t, "plain_ms": plain_ms,
            **bound(nbytes(qs, *got), k4_flops(7) * qs[..., 0].numel())}


def k4_flops(dof: int) -> int:
    """K4's float32 operations for one configuration, counted from the
    loops of `csrc/kinematics.cu` (a multiply-add counts 2; a division,
    square root, sine or cosine 1): the arm's chain and gradient, and for
    dof > 7 the planar base's composition."""
    arm = 7
    trail = sum((5 - k) ** 2 for k in range(6))  # trailing updates, 6x6
    fk = arm * (2 + 3 * 5 + 9 * 5 + 3 + 3 * 6)   # sin/cos, p_off, R_off, Rz
    ee = 3 * 6 + 9 * 5 + 3 * arm + 9 * arm       # p_e, R_e, lever arms, J
    gram = 36 * 2 * arm                          # A = J J', every entry
    det = 6 + 3 * trail + 1                      # pivots, updates, sqrt
    chol = 8 + 1 + 7 + 6 + 21 + 2 * trail        # scale, shift, pivots, L
    solves = arm * 2 * (2 * 15 + 6)              # L y = J_j, L' x_j = y
    pairs_lt, pairs_ge = arm * (arm - 1) // 2, arm * (arm + 1) // 2
    grad = pairs_lt * (4 * 9 + 3 + 11) + pairs_ge * (9 + 5) + arm * arm \
        + arm                                    # terms, sums, m dm_i
    base = 0 if dof == arm else 8 + 3 * 6 + 1 + 2 * arm * 6
    return fk + ee + gram + det + chol + solves + grad + base


def check_k4_nan(label, qs, system=None) -> None:
    """A NaN in one configuration's q (arm joint 3) at a few places -- the
    first configuration of a block, one inside a block, the last (of a
    partial block) -- gives NaN in that configuration's p, R and m and in
    the arm columns of its jv and dm (as from the plain version and the
    JAX kernel), and leaves every other configuration's outputs
    bit-identical to the run without it: the block stages and stores its
    configurations' outputs together."""
    from mpcc_manipulator_tpu_torch.ops.kinematics_kernel import kin_sweep
    from mpcc_manipulator_tpu_torch.system import PANDA
    sy = system or PANDA
    ref = kin_sweep(qs, sy)
    flat = qs.reshape(-1, sy.dof).clone()
    where = [0, 64 * 5 + 17, flat.shape[0] - 1]
    flat[where, sy.base_dof + 3] = float("nan")
    got = kin_sweep(flat.reshape(qs.shape), sy)
    torch.cuda.synchronize()
    bad = torch.zeros(flat.shape[0], dtype=torch.bool, device=qs.device)
    bad[where] = True
    names = ["p_ee", "r_ee", "jv", "jw", "manipul", "d_manipul"]
    for name, g, r in zip(names, got, ref):
        g = g.reshape(flat.shape[0], -1)
        r = r.reshape(flat.shape[0], -1)
        if not torch.equal(g[~bad], r[~bad]):
            raise AssertionError(f"{label} NaN check: {name} of a "
                                 "configuration without NaN changed")
        # the base columns are constants (jv) or zero (dm)
        arm = g[bad].reshape(len(where), -1, g.shape[1] // 3
                             if name == "jv" else g.shape[1])
        if name in ("jv", "d_manipul"):
            arm = arm[..., sy.base_dof:]
        if name != "jw" and not bool(torch.isnan(arm).all()):
            raise AssertionError(f"{label} NaN check: {name} of a NaN "
                                 "configuration is not all NaN")
    print(f"{label} NaN check: NaN in {len(where)} configurations' q "
          f"(flat {where}) stays in them; every other configuration "
          "bit-identical")


def print_k4_launches() -> None:
    """K4's launch for both systems at the batches this script runs: the
    card's report (`mpcc_kin_launch_config`) held equal to the Python
    mirror (`launch_geometry`), no local memory (stack or spill), at most
    48 KB of shared memory and at least one block for every SM at batch
    1024."""
    from mpcc_manipulator_tpu_torch.ops import kinematics_kernel as kk
    from mpcc_manipulator_tpu_torch.system import PANDA
    for sy, batches in ((PANDA, (BATCH,)), (mobile_system(), MOBILE_BATCHES)):
        for batch in batches:
            n = batch * KNOTS
            cfg = kk.launch_config(sy, n)
            mirror = kk.launch_geometry(sy, n)
            print(f"K4 launch, {sy.name}, batch {batch}: {cfg['threads']} "
                  f"threads, {cfg['configs_per_block']} configurations a "
                  f"block, {cfg['blocks']} blocks, {cfg['blocks_per_sm']} "
                  f"blocks an SM, {cfg['registers']} registers, "
                  f"{cfg['local_bytes']} B local (stack and spills), "
                  f"{cfg['shared_bytes']} B shared")
            if any(cfg[k] != v for k, v in mirror.items()):
                raise AssertionError(f"K4 launch, {sy.name}: the card "
                                     f"reports {cfg}, the mirror {mirror}")
            if cfg["local_bytes"] or cfg["shared_bytes"] > 48 * 1024 \
                    or cfg["blocks_per_sm"] < 1 \
                    or (batch == BATCH and cfg["blocks"] < cfg["sms"]):
                raise AssertionError(f"K4 launch, {sy.name}: {cfg}")


# K6: the lanes of the two benchmark cells' batches; its gaps to the plain
# version off the Panda in float32 (where it is held bit for bit): s within
# the Newton step's tolerance, vs within 1e-5 of its terms' scale; the
# stack of the trig functions' slow path (|q| > 1e5), 32 B in float32 and
# 40 B in float64, is the only local memory allowed
K6_BATCHES = (32768, 4096)
K6_DS_TOL = 1e-5
K6_VS_TOL = 1e-5
K6_LOCAL_BYTES = 40
K6_NEWTON_STEPS = 4   # the steps a lane's operation count assumes


def k6_lanes(system, track, batch, dtype, device):
    """The system's home + 0.01 N(0, 1) on every state component (the
    bench's draw), with s spread over the track and 0.3 past either end on
    every fourth lane (the waypoint fallback, the track's ends), and inputs
    0.3 N(0, 1)."""
    rng = np.random.default_rng(SEED + 6)
    x = home(system)[None] + 0.01 * rng.standard_normal((batch,
                                                          system.nx))
    length = float(track.length)
    x[::4, system.s_idx] = rng.uniform(-0.3, length + 0.3,
                                       x[::4].shape[0])
    u = 0.3 * rng.standard_normal((batch, system.nu))
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(u, dtype=dtype, device=device))


def phase_k6(device) -> list:
    """K6's launch, its agreement with the plain version and its times
    (docstring, item 7a)."""
    from mpcc_manipulator_tpu_torch.models import kinematics as kin
    from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kmob
    from mpcc_manipulator_tpu_torch.ops import projection_kernel as pk
    from mpcc_manipulator_tpu_torch.problem import build_problem
    from mpcc_manipulator_tpu_torch.splines import arc_length as als
    from mpcc_manipulator_tpu_torch.system import PANDA
    rows = []
    for system in (PANDA, mobile_system()):
        for dtype in (torch.float32, torch.float64):
            track, params, _, _ = build_problem(dtype, device, system=system)
            mdp = params.model.max_dist_proj
            nk = track.s_knots.numel()
            exact = system.base_dof == 0 and dtype == torch.float32
            label = f"K6 {system.name} {str(dtype)[6:]}"
            for batch in K6_BATCHES:
                cfg = pk.launch_config(system, dtype, batch, nk)
                if cfg["local_bytes"] > K6_LOCAL_BYTES \
                        or cfg["blocks_per_sm"] < 1:
                    raise AssertionError(f"{label}: launch {cfg}")
                x0, u0 = k6_lanes(system, track, batch, dtype, device)
                got = pk.project_and_vs(track, x0, u0, mdp, system)
                ref = pk.project_and_vs_plain(track, x0, u0, mdp, system)
                torch.cuda.synchronize()
                (x_k, s_k), (x_p, s_p) = got, ref
                q = x0[:, :system.dof].double().cpu()
                jv = (kin.ee_jacobian(q) if system.base_dof == 0
                      else kmob.ee_jacobian(q))[:, :3]
                dq = u0[:, :system.dof].double().cpu()
                tan = als.track_derivative(track, s_p).double().abs().cpu()
                scale = ((dq[:, None, :] * jv).abs().sum(-1) * tan).sum(-1)
                ds = float((s_k - s_p).abs().max())
                dvs = float(((x_k - x_p)[:, system.vs_idx].double().abs()
                             .cpu() / (scale + 1e-30)).max())
                last_s = x0[:, system.s_idx]
                jumps = int((((last_s - s_k).abs() > mdp)
                             != ((last_s - s_p).abs() > mdp)).sum())
                same = torch.equal(x_k, x_p) and torch.equal(s_k, s_p)
                share = float((s_k == s_p).double().mean())
                if (exact and not same) or jumps or ds > K6_DS_TOL \
                        or dvs > K6_VS_TOL:
                    raise AssertionError(
                        f"{label} at {batch}: bit-identical {same}, s "
                        f"bit-identical on {share:.4f} of lanes, |ds| "
                        f"{ds:.3e}, |dvs| {dvs:.3e} of scale, jump "
                        f"mismatches {jumps}")
                text = (f"{label} vs plain at {batch} lanes: "
                        f"{'bit-identical' if same else 'within tolerance'}"
                        f" (s equal on {share:.4f} of lanes, |ds| {ds:.3e}, "
                        f"|dvs| {dvs:.3e} of scale); launch {cfg}")
                if dtype != torch.float32:
                    print(text)
                    continue
                fn = lambda: pk.project_and_vs(track, x0, u0, mdp, system)
                t = kernel_times(fn, "proj_kernel<", 50)
                plain_ms = cuda_time(
                    lambda: pk.project_and_vs_plain(track, x0, u0, mdp,
                                                    system), 3)
                print(f"{text}; {times_text(t)}, plain {plain_ms:.4f} ms")
                # bytes: x0 and u0 in, x0_updated and s out, the track's
                # tables; operations: k6_flops a lane
                rows.append({
                    "name": f"K6 projection (project_and_vs), {system.name}"
                            f" at {batch}",
                    "route": "cuda",
                    "source": "mpcc_manipulator_tpu_torch/csrc/kinematics.cu",
                    "replaces": "mpc.py step 1, eager (no TPU kernel)",
                    "bit_identical": same, "max_ds": ds, "max_dvs": dvs,
                    **t, "plain_ms": plain_ms,
                    **bound(nbytes(x0, u0, *got) + 4 * (16 * nk + 96),
                            k6_flops(system.dof) * batch)})
    return rows


def k6_flops(dof: int) -> int:
    """K6's operations for one lane, counted from `csrc/kinematics.cu` (a
    multiply-add counts 2; a division, square root, sine or cosine 1):
    the plain-rounded FK and Jv, the distance to p(s), K6_NEWTON_STEPS
    Newton steps and vs; the waypoint scan, which only lanes far from
    their s run, is left out."""
    arm = 7
    fk = arm * (2 + 3 * 5 + 9 * 5 + 3 + 2 * 3) + 3 * 6   # chain, p_ee
    jv = arm * (3 + 3 * 3)                                 # lever, cross
    base = 0 if dof == arm else 2 + 4 + 2 + arm * (4 * 3 + 3 + 3 * 3)
    spline = 5 + 9 + 8 + 4                                 # seg, p, p', p''
    dist = 3 * spline + 3 + 5 + 1
    newton = 3 * spline + 3 + 5 * 3 + 6 + 2
    vs = 3 * 2 * dof + 3 * spline + 5
    return fk + jv + base + dist + K6_NEWTON_STEPS * newton + vs


# K7: the three benchmark cells' knots and batch 1, with a NaN lane; float32
# bit for bit from K7_EXACT_KNOTS on (where cuBLAS runs the plain route's
# products as one chain from k = 0), float64 and smaller batches within
# K7_GAP of each output's scale; the trig slow path's stack the only local
# memory in float32; then K7_LOOP_TICKS closed-loop ticks of each cell's
# draw, every tick's NN half held bit for bit against the plain route
K7_CASES = (("panda", 32768), ("panda", 4096), ("husky_panda", 16384),
            ("panda", 1))
K7_EXACT_KNOTS = 5632
K7_GAP = {torch.float32: 2e-6, torch.float64: 1e-14}
K7_LOCAL_BYTES = 40
K7_LOOP_TICKS = 60
K7_CELLS = (("panda.fleet-rti-b32768", "panda", 32768, {}, (3.0, 3.0, 3.0),
             0.0),
            ("panda.fleet-admm-b4096", "panda", 4096,
             dict(qp_solver="admm", qp_backend="pallas", qp_assembly="xla"),
             (3.0, 3.0, 3.0), 0.0),
            ("husky_panda.fleet-rti-obs-b16384", "husky_panda", 16384, {},
             (0.705, 0.075, 0.809), 0.05))


def k7_calls(system, qs, obs_pos, sel_nn, env_nn):
    """RobotData's two K7 calls for knots ``qs`` (B, K, dof): ``[(net, q,
    arm_offset, obs, obs_div, cols, offset)]``."""
    from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kmob
    b, k, dof = qs.shape
    q = qs.reshape(b * k, dof)
    base = system.base_dof
    if base == 0:
        env = (env_nn, q, 0, obs_pos, k, dof, 0)
    else:
        obs = obs_pos[:, None, :].expand(b, k, 3).reshape(b * k, 3)
        rb, pb = kmob._base_transform(q[:, :3])
        local = (rb.transpose(-1, -2) @ (obs - pb)[..., None])[..., 0]
        env = (env_nn, q, base, local.contiguous(), 1, system.arm_dof + 3, 0)
    return [(sel_nn, q, base, None, 1, system.arm_dof, base), env]


def k7_flops(net, masks) -> tuple:
    """K7's operations (a multiply-add 2) over the rows whose ReLU masks
    (z > 0, layer by layer) are ``masks``: ``(dense, walked)``.  Dense: the
    plain route's products.  Walked: the forward over each row's active
    inputs, the Jacobian's products over the units with z > 0 on both
    sides (rows of W_l where z_l > 0, columns where z_{l-1} > 0; W_0's
    every input column)."""
    ws = [lin.weight for lin in net.layers]
    n_out, n_enc = ws[-1].shape[0], ws[0].shape[1]
    rows = masks[0].shape[0]
    dense = sum(w.numel() for w in ws) + n_out * sum(
        w.numel() for w in ws[1:-1]) + n_out * ws[0].numel()
    act = [m.double().sum(-1) for m in masks]
    walked = rows * n_enc * ws[0].shape[0] + n_out * float(act[-1].sum())
    for l in range(1, len(act)):
        walked += float((act[l - 1] * ws[l].shape[0]).sum())
        walked += n_out * float((act[l] * act[l - 1]).sum())
    walked += n_out * n_enc * float(act[0].sum())
    return 2.0 * dense * rows, 2.0 * walked


def k7_gemm_ms(fn) -> float:
    """Device ms of the cuBLAS products one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "device_time_total", None) or e.cuda_time_total)
               for e in prof.events() if e.device_type == DeviceType.CUDA
               and any(t in e.name.lower() for t in ("gemm", "gemv",
                                                     "cutlass"))) / 1e3


def k7_same(got, ref) -> bool:
    return got.shape == ref.shape and bool(
        ((got == ref) | (torch.isnan(got) & torch.isnan(ref))).all())


def k7_gap(got, ref) -> float:
    fin = ~torch.isnan(ref)
    d = (got[fin].double() - ref[fin].double()).abs()
    return float(d.max() / (ref[fin].double().abs().max() + 1e-300))


def phase_k7(device) -> list:
    """K7's launch, its agreement with the plain version at the cells'
    shapes, its times and work counts, then the cells' closed loops held
    bit for bit (docstring, item 7b)."""
    from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
    from mpcc_manipulator_tpu_torch.ops import collision_nn_kernel as nnk
    from mpcc_manipulator_tpu_torch.system import PANDA
    systems = {"panda": PANDA, "husky_panda": mobile_system()}
    rows = []
    for dtype in (torch.float32, torch.float64):
        nets = (cnn.load_self_collision_nn(dtype, device),
                cnn.load_env_collision_nn(dtype, device))
        for net in nets:
            cfg = nnk.launch_config(net, dtype, 32768 * 11)
            if cfg["blocks_per_sm"] < 1 or (dtype == torch.float32 and
                                            cfg["local_bytes"]
                                            > K7_LOCAL_BYTES):
                raise AssertionError(f"K7 launch, {str(dtype)[6:]}: {cfg}")
            print(f"K7 {'self' if net is nets[0] else 'env'} "
                  f"{str(dtype)[6:]}: layout {nnk.layout(net, dtype)}, "
                  f"launch {cfg}")
        for sname, batch in K7_CASES:
            system = systems[sname]
            rng = np.random.default_rng(SEED + 7 + batch)
            q0 = home(system)[:system.dof]
            qs = torch.tensor(q0 + 0.01 * rng.standard_normal(
                (batch, 11, system.dof)), dtype=dtype, device=device)
            if batch > 1:
                qs[batch // 2, 4, system.base_dof + 1] = float("nan")
            sphere = torch.tensor([0.705, 0.075, 0.809], dtype=dtype,
                                  device=device)
            obs = (sphere if system.base_dof else torch.full_like(sphere, 3.0)
                   ).expand(batch, 3).contiguous()
            exact = dtype == torch.float32 and batch * 11 >= K7_EXACT_KNOTS
            label = f"K7 {sname} {str(dtype)[6:]} at {batch}"
            for args in k7_calls(system, qs, obs, *nets):
                net, q, off, o, div, cols, offset = args
                kind = "self" if o is None else "env"
                run = lambda: nnk.forward_jacobian(
                    net, q, off, o, div, cols=cols, offset=offset)
                plain = lambda: nnk.forward_jacobian_plain(
                    net, q, off, o, div, cols=cols, offset=offset)
                got = nnk.forward_jacobian(net, q, off, o, div, cols=cols,
                                           offset=offset, count=True)
                ref = nnk.forward_jacobian_plain(net, q, off, o, div,
                                                 cols=cols, offset=offset,
                                                 count=True)
                torch.cuda.synchronize()
                same = all(k7_same(a, b) for a, b in zip(got, ref))
                gaps = [k7_gap(a, b) for a, b in zip(got[:2], ref[:2])]
                nan_ok = all(torch.equal(torch.isnan(a), torch.isnan(b))
                             for a, b in zip(got[:2], ref[:2]))
                if not nan_ok or not torch.equal(got[2], ref[2]) or (
                        exact and not same) or max(gaps) > K7_GAP[dtype]:
                    raise AssertionError(
                        f"{label} {kind}: bit-identical {same}, gaps of y, "
                        f"jac {gaps}, NaN pattern equal {nan_ok}")
                share = float(got[2].double().mean()) / nnk.dense_units(net)
                text = (f"{label} {kind} vs plain: "
                        f"{'bit-identical' if same else 'within tolerance'}"
                        f" (gaps y {gaps[0]:.3e}, jac {gaps[1]:.3e}); "
                        f"nn_units_active {share:.4f}")
                if dtype != torch.float32 or batch == 1:
                    print(text)
                    continue
                x = q[:, off:off + 7]
                if o is not None:
                    x = torch.cat([x, o.repeat_interleave(div, 0)], -1)
                masks = cnn.forward_jacobian_masks(net, x)[2]
                dense, walked = k7_flops(net, masks)
                t = kernel_times(run, "nn_kernel", 10)
                plain_ms = cuda_time(plain, 3)
                nb = nbytes(q, got[0], got[1], nnk.pack(net)) + (
                    nbytes(o) if o is not None else 0)
                b_dense, b_walked = bound(nb, dense), bound(nb, walked)
                lib = k7_gemm_ms(plain)
                print(f"{text}; {times_text(t)}, plain {plain_ms:.4f} ms, "
                      f"library (the plain route's cuBLAS products) "
                      f"{lib:.4f} ms; operations dense {dense:.4e} "
                      f"(bound {b_dense['bound_ms']:.4f} ms), walked "
                      f"{walked:.4e} (bound {b_walked['bound_ms']:.4f} ms, "
                      f"{b_walked['bound_by']})")
                rows.append({
                    "name": f"K7 collision network ({kind}, "
                            f"forward_jacobian), {sname} at {batch}",
                    "route": "cuda",
                    "source": "mpcc_manipulator_tpu_torch/csrc/"
                              "collision_nn.cu",
                    "replaces": "models/collision_nn.py::"
                                "mlp_forward_jacobian, cuBLAS + eager (no "
                                "TPU kernel)",
                    "bit_identical": same, "nn_units_active": share,
                    **t, "plain_ms": plain_ms, **b_walked,
                    "dense_bound_ms": b_dense["bound_ms"],
                    "library_ms": lib})
    k7_closed_loops(device)
    return rows


def k7_closed_loops(device) -> None:
    """Each benchmark cell's draw (home + 0.01 N(0, 1), its obstacle and
    solver settings) for K7_LOOP_TICKS closed-loop ticks on the bench
    route, every tick's NN half run again on the plain route from the
    same knots and held bit for bit."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
    from mpcc_manipulator_tpu_torch.ocp import robot_data as rd
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    from mpcc_manipulator_tpu_torch.system import PANDA
    systems = {"panda": PANDA, "husky_panda": mobile_system()}
    real = rd._nn_half
    for cell, sname, batch, cfg, obs_at, radius in K7_CELLS:
        system = systems[sname]
        dt = torch.float32
        track, params, sel_nn, env_nn = build_problem(dt, device,
                                                      system=system)
        x = perturbed_states(batch, dt, device, system)
        u = torch.zeros(batch, system.nu, dtype=dt, device=device)
        obs = torch.tensor([obs_at], dtype=dt, device=device).expand(
            batch, 3).contiguous()
        rad = torch.full((batch,), radius, dtype=dt, device=device)
        carry = init_carry(batch, dt, device, system)
        held = []

        def both(qs, obs_pos, sel, env, sy, mm=None, phase=None,
                 interpret=None, keep=None):
            out = real(qs, obs_pos, sel, env, sy, mm, phase, interpret, keep)
            ref = real(qs, obs_pos, sel, env, sy, mm, interpret=True)
            held.append(all(k7_same(a, b) for a, b in zip(out, ref)))
            return out

        rd._nn_half = both
        try:
            for _ in range(K7_LOOP_TICKS):
                carry, out = mpc_step(track, params, sel_nn, env_nn, carry,
                                      x, u, obs, rad, ts=TS,
                                      cfg=SQPConfig(**cfg), system=system)
                u = out.u0
                x = sim_time_step(out.x0_updated, u, TS)
        finally:
            rd._nn_half = real
        torch.cuda.synchronize()
        if len(held) != K7_LOOP_TICKS or not all(held):
            raise AssertionError(f"K7 closed loop, {cell}: NN half "
                                 f"bit-identical on {sum(held)} of "
                                 f"{len(held)} ticks")
        print(f"K7 closed loop, {cell} ({batch} lanes x {K7_LOOP_TICKS} "
              f"ticks): every tick's NN half bit-identical to the plain "
              f"route")


def main_path_inputs(problem, device, system=None, batch=BATCH):
    """The first tick's iterate on the main path's own track, float32:
    ``(z, trial z, candidates, current u, RobotData)``.  z is the cold-start
    horizon at the ``batch`` perturbed home states; the trial points are
    z + 0.02 N(0,1) and the candidates ``CANDIDATES`` such draws per lane
    (so the inputs, their rates and the smoothness pair are non-zero);
    current u is 0.02 N(0,1); the RobotData is z's, as the SQP loop holds
    it for every iterate of a tick."""
    from mpcc_manipulator_tpu_torch.mpc import _cold_start, _unwrap_s
    from mpcc_manipulator_tpu_torch.ocp import qp_data
    from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
    from mpcc_manipulator_tpu_torch.system import PANDA
    system = system or PANDA
    track, _, sel_nn, env_nn = problem
    f32 = dict(dtype=torch.float32, device=device)
    x0 = perturbed_states(batch, torch.float32, device, system)
    z = _unwrap_s(_cold_start(x0, system), track.length, system)
    rng = np.random.default_rng(SEED + 11)
    draw = lambda *shape: torch.tensor(0.02 * rng.standard_normal(shape),
                                       **f32)
    zt = z + draw(*z.shape)
    zc = z[:, None] + draw(batch, CANDIDATES, z.shape[-1])
    cu = draw(batch, system.nu)
    xs, _ = qp_data.split_z(z, system)
    obs = torch.tensor([[3.0, 3.0, 3.0]], **f32)
    rb = compute_robot_data(xs[..., :system.dof].contiguous(),
                            obs.expand(batch, 3), torch.zeros(batch, **f32),
                            sel_nn, env_nn, mani_grad="analytic",
                            system=system, kin_backend="pallas")
    return z, zt, zc, cu, rb


def single_term_params(problem, device, system=None, batch=BATCH) -> list:
    """``(weight, params)`` for each cost weight: the main path's
    parameters with every other weight zero and this one scaled so that its
    term's median over the main path's trial points is 10 in magnitude.  A
    kernel that drops or misweights one term then fails the contract even
    where the full objective hides it (the input costs are ~1e-4 of it)."""
    from mpcc_manipulator_tpu_torch.ops.assembly_kernel import (
        eval_point_plain)
    from mpcc_manipulator_tpu_torch.system import PANDA
    system = system or PANDA
    track, params = problem[:2]
    _, zt, _, cu, rb = main_path_inputs(problem, device, system, batch)
    cost = params.cost
    zero = {w: torch.zeros_like(getattr(cost, w)) for w in COST_WEIGHTS}
    alone = lambda w, scale: dataclasses.replace(
        params, cost=dataclasses.replace(
            cost, **{**zero, w: getattr(cost, w) * scale}))
    out = []
    for w in COST_WEIGHTS:
        med = abs(float(eval_point_plain(track, zt, rb, alone(w, 1.0), cu,
                                         TS, system)[0].median()))
        if not med > 0.0:
            raise AssertionError(f"K2/K3: the {w} term is zero on the main "
                                 "path's trial points")
        out.append((w, alone(w, 10.0 / med)))
    return out


def stage_qp_batch(problem, device, system=None, batch=BATCH):
    """The StageQPK the first tick builds for the ``batch`` perturbed states
    (cold-start horizon at each state, current u zero)."""
    from mpcc_manipulator_tpu_torch.ocp import qp_stages
    from mpcc_manipulator_tpu_torch.system import PANDA
    system = system or PANDA
    track, params = problem[:2]
    z, _, _, _, rb = main_path_inputs(problem, device, system, batch)
    u0 = torch.zeros(batch, system.nu, dtype=torch.float32, device=device)
    return qp_stages.build_qp_stages_k(track, z, rb, params, u0, TS,
                                       system=system)


def compare_ipm(label, sol, ref, step_tol=5e-4, duals=True) -> float:
    """K1's solution against its plain version's: iteration counts within
    +-1, identical verdicts, steps within ``step_tol``, and (``duals``) the
    duals of solved lanes as below."""
    d_it = int((sol.iters - ref.iters).abs().max())
    if d_it > 1:
        raise AssertionError(f"K1 {label}: iteration counts differ by {d_it}")
    if not bool((sol.solved == ref.solved).all()):
        raise AssertionError(
            f"K1 {label}: verdicts differ on "
            f"{int((sol.solved != ref.solved).sum())} lanes")
    err = max(check_close(f"K1 {label} du", sol.du, ref.du, step_tol),
              check_close(f"K1 {label} dx", sol.dx_tilde, ref.dx_tilde,
                          step_tol))
    if not duals:
        print(f"K1 {label}: iters kernel mean {sol.iters.float().mean():.2f} "
              f"max {int(sol.iters.max())}, plain mean "
              f"{ref.iters.float().mean():.2f}; solved "
              f"{int(sol.solved.sum())}/{sol.solved.numel()}; "
              f"max|d du, d dx| {err:.3e}")
        return err
    # Duals on solved lanes, the JAX test's absolute 0.5, on every row whose
    # dual is at most 100.  The perturbed start (s < 0 on some lanes) puts
    # the s lower-box row on its 1e-6 clamped margin, where s ends below
    # 5e-7 and the dual (up to ~2e4) is fixed only to the solver tolerance:
    # on these inputs the plain version in float32 is 272 off its float64
    # value there, and 4.7e-4 on all other rows (measured on the CPU).
    rows = ref.solved[:, None, None] & (ref.lam.abs() <= K1_LAM_WELL_POSED)
    check_close(f"K1 {label} lam", sol.lam[rows], ref.lam[rows], 0.5)
    big = ref.solved[:, None, None] & ~rows
    big_err = float((sol.lam - ref.lam).abs()[big].max()) \
        if bool(big.any()) else 0.0
    print(f"K1 {label}: iters kernel mean {sol.iters.float().mean():.2f} "
          f"max {int(sol.iters.max())}, plain mean "
          f"{ref.iters.float().mean():.2f}; solved {int(sol.solved.sum())}/"
          f"{sol.solved.numel()}; max|d du, d dx| {err:.3e}; "
          f"{int(big.sum())} rows with |lam| > {K1_LAM_WELL_POSED}: "
          f"max|d lam| {big_err:.3e}")
    return err


def k1_flops(scheme: str, iters: torch.Tensor, system=None) -> float:
    """Float32 operations of K1 on lanes that ran ``iters`` Newton
    iterations.  Adaptive, at the Panda's dims: ~0.2 MFLOP per iteration
    (the stage blocks H + C' diag(w) C, ~50 kFLOP; the fused matrix +
    vector Riccati sweep, ~136 kFLOP; rollout, row products, targets, step
    and test, ~30 kFLOP).  Mehrotra adds one right-hand side per iteration
    (the affine probe and the corrector against one matrix sweep), counted
    from csrc/qp_ipm.cu at N stages and nr = 59 N rows:
      gradient rows 5 nr + gradient blocks 24 x 30 N + vector Riccati step
      900 N + rollout 434 N + row products 4,300 + targets 10 nr
      + the probe's mu_aff and the corrector's right-hand side 8 nr
    = 38,410 at N = 10.  At other dims each term scales with its sizes: the
    stage blocks with the slot's matrix entries, the sweeps with
    nxt^2 nu (matrix) or nxt nu (vector), the gradient blocks with their
    entries, the row terms with nc."""
    from mpcc_manipulator_tpu_torch.system import PANDA
    sy = system or PANDA
    nx, nu, dof, nxt, nc = sy.nx, sy.nu, sy.dof, sy.nxt, sy.nc_stage
    matrix_entries = nx * (nx + 1) // 2 + nu * nx + nu * (nu + 1) // 2 + dof
    per_iter = 2e5 * (50 * matrix_entries / 160 + 136 * nxt * nxt * nu / 2312
                      + 30 * nc / 59) / 216
    if scheme == "mehrotra":
        n_st, nr = KNOTS - 1, nc * (KNOTS - 1)
        vec = nxt * nu / 136
        per_iter += (5 * nr + (nx + dof + nu) * 30 * n_st
                     + (900 + 434) * vec * n_st + 4300 * nc / 59
                     + 10 * nr + 8 * nr)
    return per_iter * float(iters.double().sum())


def phase_k1(problem, device) -> dict:
    """K1 in both centering schemes, cold and warm, against its plain
    version; a NaN lane; the launch configuration; each scheme's warm
    launch timed."""
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        launch_config, solve_qp_ipm_k, solve_qp_ipm_plain)
    qpk = stage_qp_batch(problem, device)
    n_st = qpk.e.shape[1]
    entry = {"name": "K1 interior-point QP solve (solve_qp_ipm_k)",
             "route": "cuda",
             "source": "mpcc_manipulator_tpu_torch/csrc/qp_ipm.cu",
             "replaces": "mpcc_manipulator_tpu/solver/qp_ipm_pallas.py:64"}
    err = 0.0
    cfg = launch_config(n_st)
    print(f"K1 launch, both schemes (one kernel): {cfg}; "
          f"{cfg['blocks_per_sm']} x {cfg['sms']} = "
          f"{cfg['blocks_per_sm'] * cfg['sms']} scenarios at once for batch "
          f"{BATCH}")
    if cfg["local_bytes"] or cfg["blocks_per_sm"] < K1_BLOCKS_PER_SM \
            or cfg["blocks_per_sm"] * cfg["sms"] < BATCH:
        raise AssertionError(
            f"K1: {cfg['local_bytes']} B of local memory, "
            f"{cfg['blocks_per_sm']} blocks an SM: the kernel spills, or "
            f"holds fewer than {K1_BLOCKS_PER_SM} blocks an SM, or batch "
            f"{BATCH} takes more than one wave")
    for scheme in ("adaptive", "mehrotra"):
        cold = solve_qp_ipm_k(qpk, scheme=scheme)
        cold_ref = solve_qp_ipm_plain(qpk, scheme=scheme)
        torch.cuda.synchronize()
        err = max(err, compare_ipm(f"{scheme} cold", cold, cold_ref))
        # warm start from the cold solution, clipped as the SQP clips it
        ws = torch.clamp(cold_ref.s_rows, 0.1, 100.0)
        wl = torch.clamp(cold_ref.lam_rows, 0.1, 100.0)
        warm = solve_qp_ipm_k(qpk, warm_s=ws, warm_lam=wl, scheme=scheme)
        warm_ref = solve_qp_ipm_plain(qpk, warm_s=ws, warm_lam=wl,
                                      scheme=scheme)
        torch.cuda.synchronize()
        err = max(err, compare_ipm(f"{scheme} warm", warm, warm_ref))

        # a NaN in one lane's Hessian: not solved there, the other lanes
        # bit-identical
        qpk_nan = dataclasses.replace(qpk, hxx=qpk.hxx.clone())
        qpk_nan.hxx[K1_NAN_LANE, 3, 2, 2] = float("nan")
        dirty = solve_qp_ipm_k(qpk_nan, warm_s=ws, warm_lam=wl, scheme=scheme)
        torch.cuda.synchronize()
        keep = torch.ones(BATCH, dtype=torch.bool, device=device)
        keep[K1_NAN_LANE] = False
        fields = ("dx_tilde", "du", "lam", "s_rows", "iters", "solved", "mu")
        if bool(dirty.solved[K1_NAN_LANE]) or not all(
                torch.equal(getattr(dirty, f)[keep], getattr(warm, f)[keep])
                for f in fields):
            raise AssertionError(f"K1 {scheme} NaN lane: solved, or another "
                                 "lane changed")
        print(f"K1 {scheme}, NaN in hxx of lane {K1_NAN_LANE}: not solved "
              f"({int(dirty.iters[K1_NAN_LANE])} iterations), the other "
              f"{BATCH - 1} lanes bit-identical")

        t = kernel_times(lambda: solve_qp_ipm_k(qpk, warm_s=ws, warm_lam=wl,
                                                scheme=scheme),
                         "ipm_kernel<", 20)
        plain_ms = cuda_time(lambda: solve_qp_ipm_plain(
            qpk, warm_s=ws, warm_lam=wl, scheme=scheme), 3)
        # bytes: every StageQPK block and the warm rows in, the step, duals,
        # slacks and verdicts out; operations: k1_flops over the iterations
        # these inputs take
        ins = [getattr(qpk, f.name) for f in dataclasses.fields(qpk)]
        outs = [warm.dx_tilde, warm.du, warm.lam, warm.s_rows, warm.iters,
                warm.solved, warm.mu]
        b = bound(nbytes(*ins, ws, wl, *outs), k1_flops(scheme, warm.iters))
        print(f"K1 {scheme} warm solve at batch {BATCH} (mean "
              f"{warm.iters.double().mean():.3f} iterations): "
              f"{times_text(t)} (before the per-system instantiation: "
              f"{K1_PR5_MS[scheme]} ms wrapper), "
              f"plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")
        if scheme == "adaptive":
            entry.update(**t, plain_ms=plain_ms, **b,
                         registers=cfg["registers"],
                         blocks_per_sm=cfg["blocks_per_sm"])
        else:
            entry.update(mehrotra_ms=t["ms"],
                         mehrotra_wrapper_ms=t["wrapper_ms"],
                         mehrotra_host_us=t["host_us"],
                         mehrotra_plain_ms=plain_ms,
                         mehrotra_bound_ms=b["bound_ms"])
    entry["max_abs_err"] = err
    return entry


# ------------------------------------------------------------ K2 and K3


def assembly_problem(device):
    """The JAX kernel test's problem (`tests/test_pallas_assembly.py`): a
    circle around the home EE position with the identity orientation, so
    the heading error sits near pi and the rotation log's near-pi branch
    fires on some knots."""
    from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
    from mpcc_manipulator_tpu_torch.models import kinematics as kin
    from mpcc_manipulator_tpu_torch.params import load_params
    from mpcc_manipulator_tpu_torch.splines import arc_length as als
    x0 = np.array([0., 0., 0., -np.pi / 2, 0., np.pi / 2, np.pi / 4, 0.05,
                   0.1])
    ee = kin.ee_position(torch.tensor(x0[:7])).numpy()
    nt = 60
    phi = np.linspace(0, 2 * np.pi, nt)
    track = als.gen_6d_spline(
        np.linspace(0, 0.3, nt) + ee[0], 0.15 * np.cos(phi) - 0.15 + ee[1],
        0.15 * np.sin(phi) + ee[2], np.tile(np.eye(3), (nt, 1, 1)),
        dtype=torch.float32, device=device)
    params, _ = load_params(dtype=torch.float32, device=device)
    nets = (cnn.load_self_collision_nn(dtype=torch.float32, device=device),
            cnn.load_env_collision_nn(dtype=torch.float32, device=device))
    return track, params, nets, x0, ee


def region_inputs(aproblem, region: str, device):
    """(z, trial z, current u, RobotData) for ``BATCH`` lanes of a region,
    the JAX test's draw: home state + 0.002 N(0,1), each lane's knot s
    pinned to the region (spread by 0.003 per knot)."""
    from mpcc_manipulator_tpu_torch.ocp import qp_data
    from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
    track, _, (sel_nn, env_nn), x0, ee = aproblem
    length = float(track.length)
    s_values, obs, radius = {
        "interior": ([0.05, 0.3, 0.6], [3.0, 3.0, 3.0], 0.0),
        "endpoint_taper": ([length - 0.05, length - 0.005, length + 0.1],
                           [3.0, 3.0, 3.0], 0.0),
        "obstacle_scheduling": ([0.02, 0.1, 0.2],
                                [ee[0] + 0.18, ee[1], ee[2]], 5.0),
    }[region]
    rng = np.random.default_rng(SEED + 7)
    z = (np.tile(np.concatenate([np.tile(x0, 11), np.zeros(80)]), (BATCH, 1))
         + 0.002 * rng.standard_normal((BATCH, 179)))
    lane = np.arange(BATCH)
    for k in range(11):
        z[:, k * 9 + 7] = np.asarray(s_values)[lane % 3] + 0.003 * k
        if region == "obstacle_scheduling":
            # every third lane's wrist near-singular (m ~ 0.018): the
            # proximity weight scheduling fires there
            z[lane % 3 == 0, k * 9 + 5] = 0.05
    zt = z + 0.02 * rng.standard_normal(z.shape)
    cu = 0.02 * rng.standard_normal((BATCH, 8))
    f32 = dict(dtype=torch.float32, device=device)
    z, zt, cu = (torch.tensor(a, **f32) for a in (z, zt, cu))
    xs, _ = qp_data.split_z(z)
    rb = compute_robot_data(xs[..., :7].contiguous(),
                            torch.tensor(obs, **f32).expand(BATCH, 3),
                            torch.full((BATCH,), radius, **f32), sel_nn,
                            env_nn, mani_grad="analytic", kin_backend="pallas")
    return z, zt, cu, rb


REGIONS = ("interior", "endpoint_taper", "obstacle_scheduling")


def k2_cases(problem, aproblem, device):
    """(label, track, params, z, current u, RobotData): the main path's
    iterate and trial point on its own track, whose objective and blocks
    are O(10) (the circle track's heading error near pi scales them by
    ~q_ori pi^2), the trial point with one cost term at a time, then the
    three regions of the JAX kernel test."""
    z, zt, _, cu, rb = main_path_inputs(problem, device)
    yield "main path", *problem[:2], z, cu, rb
    yield "main path trial", *problem[:2], zt, cu, rb
    for w, params in single_term_params(problem, device):
        yield f"main path trial, {w} alone", problem[0], params, zt, cu, rb
    for region in REGIONS:
        z, _, cu, rb = region_inputs(aproblem, region, device)
        yield region, *aproblem[:2], z, cu, rb


def check_k2(label, got, ref) -> float:
    """K2's blocks against the plain version's, each within K23_TOL x
    max(1, max|block|); prints the worst block's error relative to its
    scale."""
    err, worst = 0.0, (0.0, "")
    for f in dataclasses.fields(ref):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if g.shape != r.shape or not g.is_contiguous():
            raise AssertionError(f"{label} {f.name}: {tuple(g.shape)}, "
                                 f"expected contiguous {tuple(r.shape)}")
        scale = max(1.0, float(r.abs().max()))
        e = check_close(f"{label} {f.name}", g, r, K23_TOL * scale)
        err = max(err, e)
        worst = max(worst, (e / scale, f.name))
    print(f"{label} vs plain, {got.e.shape[0]} lanes: every block within "
          f"{K23_TOL} x max(1, max|block|); worst {worst[1]} {worst[0]:.3e} "
          f"of its scale")
    return err


def horizon_cases(problem, device, system, batch):
    """``(label, system at N, z, trial z, candidates, current u,
    RobotData)`` at N = 5 and N = 20 (ROADMAP item 13): the main path's
    inputs at that horizon, which the plain version takes as they are."""
    for n in (5, 20):
        sy = dataclasses.replace(system, horizon=n)
        yield (f"{system.name} N = {n}", sy,
               *main_path_inputs(problem, device, sy, batch))


def phase_k2(problem, aproblem, device) -> dict:
    from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
    from mpcc_manipulator_tpu_torch.ops.assembly_kernel import (
        build_qp_stages_k_kernel, build_qp_stages_k_plain)
    from mpcc_manipulator_tpu_torch.system import PANDA
    err = 0.0
    for region, track, params, z, cu, rb in k2_cases(problem, aproblem,
                                                     device):
        m = params.model
        got = build_qp_stages_k_kernel(track, z, rb, params, cu, TS)
        ref = build_qp_stages_k_plain(track, z, rb, params, cu, TS)
        torch.cuda.synchronize()
        err = max(err, check_k2(f"K2 {region}", got, ref))
        ratio = torch.minimum(rb.sel_dist / (m.tol_selcol * 2.0),
                              rb.manipul / (m.tol_sing * 2.0))
        env_h = (0.01 * (rb.env_dist - 1.2 * rb.obs_radius[..., None])
                 - 0.01 * m.tol_envcol)
        print(f"  {region}: min scheduling ratio {float(ratio.min()):.3f}, "
              f"min env h {float(env_h.min()):.4f}")
        if region == "obstacle_scheduling" and not (
                float(ratio.min()) < 1.0 and float(env_h.min()) < 0.0):
            raise AssertionError("K2: the obstacle region does not fire the "
                                 "scheduling and the env barrier")

    # NaN iterates reach every output the plain version's NaN reaches
    track, params = aproblem[:2]
    z, _, cu, rb = region_inputs(aproblem, "interior", device)
    z_nan = z.clone()
    for lane, idx in NAN_ENTRIES:
        z_nan[lane, idx] = float("nan")
    got = build_qp_stages_k_kernel(track, z_nan, rb, params, cu, TS)
    ref = build_qp_stages_k_plain(track, z_nan, rb, params, cu, TS)
    torch.cuda.synchronize()
    lanes = torch.tensor([lane for lane, _ in NAN_ENTRIES], device=device)
    n_nan = 0
    for f in dataclasses.fields(ref):
        rn = torch.isnan(getattr(ref, f.name)[lanes])
        gn = torch.isnan(getattr(got, f.name)[lanes])
        if bool((rn & ~gn).any()):
            raise AssertionError(f"K2 NaN: {f.name} finite where the plain "
                                 "version is NaN")
        n_nan += int(rn.sum())
    guard = ("hxx", "gx", "cpx", "d_p", "d_xu", "d_xl")
    for i in range(len(NAN_ENTRIES)):
        if not any(bool(torch.isnan(getattr(got, f)[lanes[i]]).any())
                   for f in guard):
            raise AssertionError("K2 NaN: the SQP's NaN guard would not see "
                                 f"lane {int(lanes[i])}")
    print(f"K2 NaN iterates (lanes {lanes.tolist()}): NaN on all {n_nan} "
          "entries where the plain version is NaN; the NaN guard's blocks "
          "carry it")

    track, params = problem[:2]
    for label, sy, z, _, _, cu, rb in horizon_cases(problem, device, PANDA,
                                                     BATCH):
        err = max(err, check_k2(
            f"K2 {label}",
            build_qp_stages_k_kernel(track, z, rb, params, cu, TS, system=sy),
            build_qp_stages_k_plain(track, z, rb, params, cu, TS,
                                    system=sy)))
    z, _, _, cu, rb = main_path_inputs(problem, device)
    t = kernel_times(lambda: build_qp_stages_k_kernel(track, z, rb, params,
                                                      cu, TS),
                     "assembly_kernel<", 50)
    plain_ms = cuda_time(lambda: build_qp_stages_k_plain(track, z, rb, params,
                                                         cu, TS), 10)
    print(f"K2 assembly at batch {BATCH} (main path): {times_text(t)}, "
          f"plain {plain_ms:.4f} ms")
    # bytes: the iterate, current input, the RobotData fields K2 reads and
    # its table in, the blocks it writes out; operations: ~3 kFLOP per
    # (scenario, knot) (spline, Rodrigues and log, three 3 x nx Jacobians
    # and their Gauss-Newton products, the polytopic rows)
    got = build_qp_stages_k_kernel(track, z, rb, params, cu, TS)
    robot = [getattr(rb, f) for f in ak._K2_ROBOT]
    table = ak.pack_tables(track, params, TS)
    return {"name": "K2 stage-QP assembly (build_qp_stages_k_kernel)",
            "route": "cuda",
            "source": "mpcc_manipulator_tpu_torch/csrc/assembly.cu",
            "replaces": "mpcc_manipulator_tpu/ops/pallas_assembly.py:290",
            "max_abs_err": err, **t, "plain_ms": plain_ms,
            **bound(nbytes(z, cu, *robot, table, *(getattr(got, f) for f
                                                    in ak._K2_OUT)),
                    3e3 * BATCH * KNOTS)}


def check_k3(label, got, ref) -> float:
    """K3's (obj, vio) against the plain version's, rtol = atol; prints the
    case's error and the objective's scale, which sets the tolerance."""
    (obj, vio), (robj, rvio) = got, ref
    err = max(check_close(f"K3 {label} obj", obj, robj, K23_TOL, K23_TOL),
              check_close(f"K3 {label} vio", vio, rvio, K23_TOL, K23_TOL))
    print(f"K3 vs plain, {label}: max|err| {err:.3e}; objective median "
          f"{float(robj.median()):.3f}, max {float(robj.max()):.3f}; max "
          f"violation {float(rvio.max()):.3f}")
    return err


def phase_k3(problem, aproblem, device) -> dict:
    from mpcc_manipulator_tpu_torch.ops.assembly_kernel import (
        eval_point_kernel, eval_point_plain)
    from mpcc_manipulator_tpu_torch.system import PANDA
    # the main path: trial points and the candidate axis (CANDIDATES
    # iterates per lane against the lane's one RobotData) on its own track
    track, params = problem[:2]
    _, zt_main, zc_main, cu_main, rb_main = main_path_inputs(problem, device)
    got = eval_point_kernel(track, zt_main, rb_main, params, cu_main, TS)
    ref = eval_point_plain(track, zt_main, rb_main, params, cu_main, TS)
    err = check_k3("main path trial", got, ref)
    vio_max = float(ref[1].max())
    got = eval_point_kernel(track, zc_main, rb_main, params, cu_main, TS)
    ref = eval_point_plain(track, zc_main, rb_main, params, cu_main, TS)
    err = max(err, check_k3(f"main path x{CANDIDATES} candidates", got, ref))
    for w, p_w in single_term_params(problem, device):
        err = max(err, check_k3(
            f"main path trial, {w} alone",
            eval_point_kernel(track, zt_main, rb_main, p_w, cu_main, TS),
            eval_point_plain(track, zt_main, rb_main, p_w, cu_main, TS)))
    # the three regions of the JAX kernel test, and a candidate axis there
    track, params = aproblem[:2]
    for region in REGIONS:
        _, zt, cu, rb = region_inputs(aproblem, region, device)
        ref = eval_point_plain(track, zt, rb, params, cu, TS)
        err = max(err, check_k3(region, eval_point_kernel(
            track, zt, rb, params, cu, TS), ref))
        vio_max = max(vio_max, float(ref[1].max()))
    if not vio_max > 0.1:
        raise AssertionError(f"K3: the perturbation does not violate "
                             f"(max violation {vio_max:.3e})")
    _, zt, cu, rb = region_inputs(aproblem, "interior", device)
    rng = torch.Generator(device=device).manual_seed(SEED)
    zc = (zt[:, None] + 0.01 * torch.randn(BATCH, CANDIDATES, zt.shape[-1],
                                           generator=rng, device=device))
    err = max(err, check_k3(
        f"interior x{CANDIDATES} candidates",
        eval_point_kernel(track, zc, rb, params, cu, TS),
        eval_point_plain(track, zc, rb, params, cu, TS)))
    # NaN iterates reach the objective or the violation as in the plain
    z_nan = zt.clone()
    for lane, idx in NAN_ENTRIES:
        z_nan[lane, idx] = float("nan")
    got = eval_point_kernel(track, z_nan, rb, params, cu, TS)
    ref = eval_point_plain(track, z_nan, rb, params, cu, TS)
    for g, r in zip(got, ref):
        if bool((torch.isnan(r) & ~torch.isnan(g)).any()):
            raise AssertionError("K3 NaN: finite where the plain version is "
                                 "NaN")
    torch.cuda.synchronize()
    track, params = problem[:2]
    for label, sy, _, zt, zc, cu, rb in horizon_cases(problem, device, PANDA,
                                                       BATCH):
        for what, zz in (("trial", zt), (f"x{CANDIDATES}", zc)):
            err = max(err, check_k3(
                f"{label} {what}",
                eval_point_kernel(track, zz, rb, params, cu, TS, sy),
                eval_point_plain(track, zz, rb, params, cu, TS, sy)))
    main = (rb_main, params, cu_main, TS)
    t = kernel_times(lambda: eval_point_kernel(track, zt_main, *main),
                     "eval_kernel<", 50)
    plain_ms = cuda_time(lambda: eval_point_plain(track, zt_main, *main), 10)
    t_c = kernel_times(lambda: eval_point_kernel(track, zc_main, *main),
                       "eval_kernel<", 50)
    plain_ms_c = cuda_time(lambda: eval_point_plain(track, zc_main, *main), 5)
    print(f"K3 vs plain, main path + 3 regions, {BATCH} lanes: max|err| "
          f"{err:.3e} (rtol = atol = {K23_TOL}), max violation "
          f"{vio_max:.3f}; NaN lanes propagate; batch {BATCH} (main path): "
          f"{times_text(t)}, plain {plain_ms:.4f} ms; x{CANDIDATES} "
          f"candidates: {times_text(t_c)}, plain {plain_ms_c:.4f} ms")
    # bytes: the trial points, current input, the RobotData fields K3
    # reads and the table in, (obj, vio) out; operations: ~1.5 kFLOP per
    # (lane, knot) (one stage cost and its constraint rows)
    from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
    robot = [getattr(rb_main, f) for f in ak._K3_ROBOT]
    return {"name": "K3 line-search evaluation (eval_point_kernel)",
            "route": "cuda",
            "source": "mpcc_manipulator_tpu_torch/csrc/assembly.cu",
            "replaces": "mpcc_manipulator_tpu/ops/pallas_assembly.py:756",
            "max_abs_err": err, **t, "plain_ms": plain_ms,
            "candidates_device_ms": t_c["device_ms"],
            "candidates_wrapper_ms": t_c["wrapper_ms"],
            **bound(nbytes(zt_main, cu_main, *robot,
                           ak.pack_tables(track, params, TS))
                    + 8 * BATCH, 1.5e3 * BATCH * KNOTS)}


# ------------------------------------------------------------ K5


def random_qps(batch: int, device):
    """The JAX kernel test's random QPs (`tests/test_pallas_admm.py`, n=40,
    m=70, ~60 one-sided rows), one per seed 0..batch-1, float32."""
    qps = []
    for seed in range(batch):
        rng = np.random.default_rng(seed)
        n, m = 40, 70
        q_half = rng.standard_normal((n, n))
        lo = np.concatenate([rng.standard_normal(10), -1e30 * np.ones(m - 10)])
        qps.append((q_half @ q_half.T + 0.5 * np.eye(n),
                    rng.standard_normal(n), rng.standard_normal((m, n)), lo,
                    np.concatenate([lo[:10], rng.uniform(0.5, 2.0, m - 10)])))
    return [torch.tensor(np.stack(v), dtype=torch.float32, device=device)
            for v in zip(*qps)]


def boxed_qps(batch: int, n: int, m: int, device):
    """Random QPs whose rows are all two-sided, |a_i x| <= 0.5 (P = 0.01 G
    G' + I, G, A and q standard normal), one per seed 0..batch-1, float32.
    Without equality rows the ADMM loop leaves them at the same chunk
    whatever the summation order; the JAX test's random QPs with an
    equality row at these sizes sit on the termination bounds for chunks on
    end, so two summation orders (float32 and float64 on the CPU, for one)
    stop them chunks apart on many lanes."""
    qps = []
    for seed in range(batch):
        rng = np.random.default_rng(seed)
        g = 0.1 * rng.standard_normal((n, n))
        qps.append((g @ g.T + np.eye(n), rng.standard_normal(n),
                    rng.standard_normal((m, n)), np.full(m, -0.5),
                    np.full(m, 0.5)))
    return [torch.tensor(np.stack(v), dtype=torch.float32, device=device)
            for v in zip(*qps)]


def mpcc_sized_qp(device):
    """The JAX kernel test's QP with the MPCC dimensions (179 x 479): box
    rows, 90 dense rows of which 45 equalities, all-zero rows with
    l = u = 0 (like the dVs rate slots), batch 1."""
    n, m = 179, 479
    rng = np.random.default_rng(2)
    qh = rng.standard_normal((n, n)) * 0.1
    a = np.zeros((m, n))
    a[:n] = np.eye(n)
    a[n:n + 90] = rng.standard_normal((90, n)) * 0.3
    lo, hi = np.full(m, -1e30), np.full(m, 1e30)
    lo[:n], hi[:n] = -2.0, 2.0
    lo[n:n + 45] = hi[n:n + 45] = 0.3
    lo[n + 90:] = hi[n + 90:] = 0.0
    qp = (qh @ qh.T + np.eye(n), rng.standard_normal(n), a, lo, hi)
    return [torch.tensor(v[None], dtype=torch.float32, device=device)
            for v in qp]


def main_path_qps(problem, device):
    """The dense QPs (P, q, A, l - c, u - c) the ADMM path builds at the
    first tick's iterate: the cold-start horizon at the ``BATCH`` perturbed
    states, current u zero."""
    from mpcc_manipulator_tpu_torch.ocp import qp_data
    track, params = problem[:2]
    z, _, _, _, rb = main_path_inputs(problem, device, batch=BATCH)
    u0 = torch.zeros(BATCH, 8, dtype=torch.float32, device=device)
    p, q, a, lo, hi, _, constr = qp_data.build_qp(track, z, rb, params, u0,
                                                  TS)
    return [p, q, a, lo - constr, hi - constr]


def k5_inputs(qp, warm=None) -> list:
    """K5's arguments for a batch of QPs: Ruiz scaling, per-row rho and the
    explicit K^-1 (`solver/qp_admm.equilibrated`), then x0, z0, y0 (zeros,
    or ``warm``)."""
    from mpcc_manipulator_tpu_torch.solver import qp_admm
    p_s, q_s, a_s, l_s, u_s, d, e, c, rho, kinv = qp_admm.equilibrated(*qp)
    b, m, n = a_s.shape
    if warm is None:
        warm = (q_s.new_zeros(b, n), q_s.new_zeros(b, m),
                q_s.new_zeros(b, m))
    return [t.contiguous() for t in (kinv, p_s, a_s, q_s, rho, l_s, u_s, d,
                                     e, c, *warm)]


def k5_flops(args, it) -> float:
    """Float32 operations of one K5 launch on ``args`` whose lanes ran
    ``it`` iterations: per iteration A'w, rhs' K^-1 and A x (4mn + 2n^2)
    plus the elementwise updates; per test x'P, y'A (2n^2 + 2mn) and the
    maxima; A x0 once at entry."""
    b, m, n = args[2].shape
    it = it.double()
    per_iter = 4 * m * n + 2 * n * n + 10 * m + 4 * n
    per_test = 2 * n * n + 2 * m * n + 10 * (m + n)
    return float((it * per_iter + (it / 25 + 1) * per_test).sum()
                 + b * 2 * m * n)


def compare_k5(label, args, max_iter, x_tol, cluster=0):
    """K5 against its plain version on the same arguments, at the cluster
    size ``fused_admm`` picks (``cluster`` 0) or at ``cluster`` blocks per
    scenario; returns (max |dx|, the kernel's outputs).

    The JAX test's residual bounds hold on its two random seeds; in float32
    they do not hold on every lane of 256 random QPs or of the main path's
    QPs, for the plain version either (measured on the CPU: dual residual
    up to 1.7e-2 on the random QPs through ``solve_qp``, primal up to
    2.0e-2 on the main path at 400 iterations).  Where a lane has not
    converged, its residual at the cap is roundoff-driven noise of the
    trajectory, and two float32 summation orders differ there by tens of
    percent.  So the kernel is held on the batch: it meets the bounds on
    no fewer lanes than the plain version (less 1 % of the lanes), and its
    largest residuals stay within twice the plain version's."""
    from mpcc_manipulator_tpu_torch.ops.admm_kernel import (
        fused_admm, fused_admm_cluster, fused_admm_plain)
    from mpcc_manipulator_tpu_torch.solver.qp_admm import residuals
    if cluster:
        label = f"{label}, cluster {cluster}"
        got = fused_admm_cluster(cluster, *args, max_iter=max_iter)
    else:
        got = fused_admm(*args, max_iter=max_iter)
    ref = fused_admm_plain(*args, max_iter=max_iter)
    torch.cuda.synchronize()
    err = check_close(f"K5 {label} x", got[0], ref[0], x_tol)
    d_it = (got[3] - ref[3]).abs()
    scaled = (args[1], args[3], args[2], args[7], args[8], args[9])
    r_k = residuals(*scaled, *got[:3])[:2]
    r_p = residuals(*scaled, *ref[:3])[:2]
    meets = int(((r_p[0] < K5_RES[0]) & (r_p[1] < K5_RES[1])).sum())
    kernel_meets = int(((r_k[0] < K5_RES[0]) & (r_k[1] < K5_RES[1])).sum())
    worst_k = [float(r.max()) for r in r_k]
    worst_p = [float(r.max()) for r in r_p]
    print(f"K5 vs plain, {label}, {args[0].shape[0]} lanes, max_iter "
          f"{max_iter}: max|dx| {err:.3e} (tol {x_tol}); iterations kernel "
          f"mean {got[3].double().mean():.2f} max {int(got[3].max())}, "
          f"plain mean {ref[3].double().mean():.2f}; |d it| max "
          f"{int(d_it.max())}, > 0 on {int((d_it > 0).sum())} lanes, > one "
          f"chunk on {int((d_it > 25).sum())}; residuals max kernel "
          f"{worst_k[0]:.3e} / {worst_k[1]:.3e}, plain {worst_p[0]:.3e} / "
          f"{worst_p[1]:.3e}; within {K5_RES}: plain {meets}, kernel "
          f"{kernel_meets} lanes")
    lanes = args[0].shape[0]
    if (kernel_meets < meets - 0.01 * lanes
            or not all(k <= 2.0 * p for k, p in zip(worst_k, worst_p))):
        raise AssertionError(f"K5 {label}: residuals not held (within the "
                             f"bounds on {kernel_meets} lanes against "
                             f"{meets}; max {worst_k} against {worst_p})")
    if float((d_it > 25).double().mean()) > 0.01:
        raise AssertionError(f"K5 {label}: iteration counts differ by more "
                             "than one chunk on more than 1 % of lanes")
    return err, got


def k5_cases(device):
    """(key, label, K5's arguments, max_iter, x tolerance) of the QPs K5 is
    held on beside the main path's."""
    return [("random", "random QPs (n=40, m=70)",
             k5_inputs(random_qps(K5_RANDOM_BATCH, device)), 500,
             K5_X_TOL["random"]),
            ("tiny", "tiny QPs (n=6, m=3)",
             k5_inputs(boxed_qps(K5_RANDOM_BATCH, 6, 3, device)), 500,
             K5_X_TOL["random"]),
            ("ragged", "ragged QPs (n=41, m=73)",
             k5_inputs(boxed_qps(K5_RANDOM_BATCH, 41, 73, device)), 500,
             K5_X_TOL["random"]),
            ("mpcc_sized", "MPCC-sized QP", k5_inputs(mpcc_sized_qp(device)),
             1000, K5_X_TOL["mpcc_sized"])]


def print_k5_launches(cases) -> None:
    """K5's launch at each shape and cluster size this phase drives (the
    build log above has ptxas's report on ``admm_kernel``)."""
    from mpcc_manipulator_tpu_torch.ops.admm_kernel import launch_config
    for key, label, args, _, _ in cases:
        _, m, n = args[2].shape
        for cluster in K5_CLUSTERS[key]:
            print(f"K5 launch, {label}, cluster {cluster or 'auto'}: "
                  f"{launch_config(n, m, cluster)}")


def phase_k5(problem, device) -> dict:
    from mpcc_manipulator_tpu_torch.ops.admm_kernel import (
        fused_admm, fused_admm_cluster, fused_admm_plain)
    cases = k5_cases(device)
    print_k5_launches(cases)
    err = 0.0
    for key, label, args, max_iter, x_tol in cases:
        for cluster in K5_CLUSTERS[key]:
            err = max(err, compare_k5(label, args, max_iter, x_tol,
                                      cluster)[0])
    qps = main_path_qps(problem, device)
    cold_args = k5_inputs(qps)
    e, cold = compare_k5("main path, cold", cold_args,
                         ADMM_CONVERGED["qp_max_iter"], K5_X_TOL["main path"])
    err = max(err, e)
    warm_args = k5_inputs(qps, cold[:3])
    err = max(err, compare_k5("main path, warm from the cold solve",
                              warm_args, ADMM_CONVERGED["qp_max_iter"],
                              K5_X_TOL["main path"])[0])
    err = max(err, compare_k5("main path, cold", cold_args,
                              ADMM_CONVERGED["qp_max_iter"],
                              K5_X_TOL["main path"], K5_ALT_CLUSTER)[0])

    # a NaN lane runs to its budget and leaves every other lane unchanged
    budget = ADMM_RTI["qp_max_iter"]
    clean = fused_admm(*cold_args, max_iter=budget)
    nan_args = list(cold_args)
    nan_args[3] = cold_args[3].clone()
    nan_args[3][K5_NAN_LANE, 0] = float("nan")
    dirty = fused_admm(*nan_args, max_iter=budget)
    torch.cuda.synchronize()
    keep = torch.ones(BATCH, dtype=torch.bool, device=device)
    keep[K5_NAN_LANE] = False
    if not (bool(torch.isnan(dirty[0][K5_NAN_LANE]).all())
            and int(dirty[3][K5_NAN_LANE]) == budget
            and all(torch.equal(d[keep], c[keep])
                    for d, c in zip(dirty, clean))):
        raise AssertionError("K5 NaN lane: not NaN, not run to its budget, "
                             "or another lane changed")
    print(f"K5 NaN in q of lane {K5_NAN_LANE}: x NaN, {budget} iterations, "
          f"the other {BATCH - 1} lanes bit-identical")

    # time one launch at the RTI budget on the main path's cold QPs, at
    # the cluster size fused_admm picks and at the other one that holds it
    t = kernel_times(lambda: fused_admm(*cold_args, max_iter=budget),
                     "admm_kernel", 20)
    alt_ms = cuda_time(lambda: fused_admm_cluster(
        K5_ALT_CLUSTER, *cold_args, max_iter=budget), 20)
    plain_ms = cuda_time(lambda: fused_admm_plain(*cold_args,
                                                  max_iter=budget), 3)
    x, z, y, it = fused_admm(*cold_args, max_iter=budget)
    b = bound(nbytes(*cold_args, x, z, y) + 4 * BATCH,
              k5_flops(cold_args, it))
    print(f"K5 at batch {BATCH}, main path cold, max_iter {budget} (mean "
          f"{it.double().mean():.2f} iterations): {times_text(t)} "
          f"(cluster {K5_ALT_CLUSTER}: wrapper {alt_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return {"name": "K5 fused ADMM loop (fused_admm)", "route": "cuda",
            "source": "mpcc_manipulator_tpu_torch/csrc/admm.cu",
            "replaces": "mpcc_manipulator_tpu/ops/pallas_admm.py:39",
            "max_abs_err": err, **t, "plain_ms": plain_ms, **b}


# ------------------------------------------------------------ closed loops


def closed_loop(problem, x0, ticks, cfg, record: int = 0, system=None):
    """``ticks`` closed-loop ticks from states ``x0``; returns per-tick
    host times, ok flags, plant states, IPM and SQP iterations, and for the
    first ``record`` lanes each tick's inputs (state, input, carry) on the
    CPU."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry, init_carry, mpc_step
    from mpcc_manipulator_tpu_torch.system import PANDA
    system = system or PANDA
    track, params, sel_nn, env_nn = problem
    b, dtype, dev = x0.shape[0], x0.dtype, x0.device
    carry = init_carry(b, dtype, dev, system)
    x, u = x0, torch.zeros(b, system.nu, dtype=dtype, device=dev)
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=dtype, device=dev).expand(b, 3)
    rad = torch.zeros(b, dtype=dtype, device=dev)
    times, oks, states, iters, sqp_iters, inputs = [], [], [], [], [], []
    for _ in range(ticks):
        if record:
            inputs.append((x[:record].cpu(), u[:record].cpu(), MPCCarry(**{
                f.name: getattr(carry, f.name)[:record].cpu()
                for f in dataclasses.fields(MPCCarry)})))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x, u,
                              obs, rad, ts=TS, cfg=cfg, system=system)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        oks.append(out.ok.cpu())
        states.append(x.cpu())
        iters.append(out.qp_iters.cpu())
        sqp_iters.append(out.sqp_iters.cpu())
    return (times, torch.stack(oks), torch.stack(states), torch.stack(iters),
            torch.stack(sqp_iters), inputs)


def check_ok(label, oks, states):
    if not bool(oks.all()):
        bad = (~oks).nonzero()[:5].tolist()
        raise AssertionError(f"{label}: not-ok (tick, lane) e.g. {bad}")
    if not bool(torch.isfinite(states).all()):
        raise AssertionError(f"{label}: non-finite states")


def phase_closed_loop(problem, device, card):
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    x0 = perturbed_states(BATCH, torch.float32, device)
    reset_counts()
    times, oks, states, iters, _, _ = closed_loop(problem, x0, TICKS,
                                                  SQPConfig())
    launches = read_counts()
    check_ok("closed loop", oks, states)
    # The perturbed start puts the EE up to ~1 cm off the track, and the
    # per-tick projection may move s back while contouring pulls the arm
    # in (measured on the CPU in float32: 283 of 1024 lanes at the first
    # tick, none after tick 11); past that transient s must rise every tick.
    s = states[:, :, 7]
    back = (s[1:] <= s[:-1]).sum(1)
    if not bool((s[S_RISING_FROM + 1:] > s[S_RISING_FROM:-1]).all()) \
            or not bool((s[-1] > s[0]).all()):
        raise AssertionError(
            f"closed loop: s not strictly increasing after tick "
            f"{S_RISING_FROM}; non-increasing lanes per tick {back.tolist()}")
    for name, n in launches.items():
        if n != {"K5": 0, "K7": 2 * TICKS}.get(name, TICKS):
            raise AssertionError(f"closed loop: {name} launched {n} times "
                                 f"in {TICKS} ticks")
    med = statistics.median(times[1:])
    print(f"closed loop (RTI, K1-K4, K6) {BATCH} x {TICKS} ticks on {card}: "
          f"all ok; median tick {med * 1e3:.3f} ms (first "
          f"{times[0] * 1e3:.1f} ms), {BATCH / med:.1f} solves/s; mean IPM "
          f"iters {iters.float().mean():.2f}, max {int(iters.max())}; "
          f"non-increasing s lane-ticks {int(back.sum())}; "
          f"s {float(s[0].mean()):.5f} -> {float(s[-1].mean()):.5f}; "
          f"launches {launches}")
    return x0, states, launches


def phase_converged(problem, x0, card):
    """The converged mode and its two options; each run's kernel launches
    against the SQP iterations it ran (the loop runs until its slowest
    lane is done)."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    runs = [("converged", dict(), CONV_TICKS, dict(K1=1, K2=1, K3=1)),
            ("converged + SOC", dict(do_SOC=True), OPTION_TICKS,
             dict(K1=2, K2=1, K3=1)),
            ("converged + merit", dict(line_search="merit"), OPTION_TICKS,
             dict(K1=1, K2=1, K3=2))]
    conv = None
    for label, change, ticks, per_iter in runs:
        reset_counts()
        times, oks, states, iters, sqp_iters, inputs = closed_loop(
            problem, x0, ticks, SQPConfig(**CONVERGED, **change),
            record=CHECK_LANES if conv is None else 0)
        launches = read_counts()
        check_ok(label, oks, states)
        run_iters = int(sqp_iters.max(1).values.sum())
        want = {k: per_iter[k] * run_iters for k in per_iter}
        want.update(K4=ticks, K5=0, K6=ticks, K7=2 * ticks)
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{want} for {run_iters} SQP iterations")
        med = statistics.median(times[1:])
        print(f"{label} {BATCH} x {ticks} ticks on {card}: all ok; SQP "
              f"iterations per lane-tick mean "
              f"{sqp_iters.float().mean():.3f}, max {int(sqp_iters.max())}; "
              f"{run_iters} run; mean IPM iters per lane-tick "
              f"{iters.float().mean():.2f}; median tick {med * 1e3:.3f} ms; "
              f"launches {launches}")
        if conv is None:
            conv = (states, inputs)
    return conv


def phase_mehrotra_rti(problem, x0, card):
    """The Riccati path under RTI with Mehrotra's centering in K1 (the JAX
    bench's ``MPCC_IPM_SCHEME=mehrotra``): 1024 x ``MEHROTRA_TICKS`` ticks,
    every lane ok, K1 launched once per SQP iteration, K2-K4 once per
    tick.  Each K1 call's QP, warm start and result are kept for the CPU
    check."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.solver import sqp
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import solve_qp_ipm_k
    solves = []

    def recorded(rep, **kw):
        sol = solve_qp_ipm_k(rep, **kw)
        solves.append((rep, kw, sol))
        return sol

    sqp.solve_qp_ipm_k = recorded
    try:
        reset_counts()
        times, oks, states, iters, sqp_iters, inputs = closed_loop(
            problem, x0, MEHROTRA_TICKS, SQPConfig(**MEHROTRA_RTI),
            record=CHECK_LANES)
        launches = read_counts()
    finally:
        sqp.solve_qp_ipm_k = solve_qp_ipm_k
    check_ok("Mehrotra RTI", oks, states)
    run_iters = int(sqp_iters.max(1).values.sum())
    want = dict(K1=run_iters, K2=MEHROTRA_TICKS, K3=MEHROTRA_TICKS,
                K4=MEHROTRA_TICKS, K5=0, K6=MEHROTRA_TICKS,
                K7=2 * MEHROTRA_TICKS)
    if run_iters != MEHROTRA_TICKS or launches != want:
        raise AssertionError(f"Mehrotra RTI: launches {launches}, expected "
                             f"{want} for {run_iters} SQP iterations")
    med = statistics.median(times[1:])
    s = states[:, :, 7]
    print(f"Mehrotra RTI (K1-K4) {BATCH} x {MEHROTRA_TICKS} ticks on {card}: "
          f"all ok; median tick {med * 1e3:.3f} ms (first "
          f"{times[0] * 1e3:.1f} ms), {BATCH / med:.1f} solves/s; mean IPM "
          f"iters {iters.float().mean():.2f}, max {int(iters.max())}; "
          f"s {float(s[0].mean()):.5f} -> {float(s[-1].mean()):.5f}; "
          f"launches {launches}")
    return states, iters, inputs, launches, solves


def phase_admm_rti(problem, x0, card):
    """The dense ADMM path under RTI: 1024 x ``ADMM_TICKS`` ticks, K5 twice
    per tick (phase 1 and phase 2 of each QP solve), K4 once."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    reset_counts()
    times, oks, states, iters, _, inputs = closed_loop(
        problem, x0, ADMM_TICKS, SQPConfig(**ADMM_RTI), record=CHECK_LANES)
    launches = read_counts()
    check_ok("ADMM RTI", oks, states)
    want = dict(K1=0, K2=0, K3=0, K4=ADMM_TICKS, K5=2 * ADMM_TICKS,
                K6=ADMM_TICKS, K7=2 * ADMM_TICKS)
    if launches != want:
        raise AssertionError(f"ADMM RTI: launches {launches}, expected "
                             f"{want}")
    med = statistics.median(times[1:])
    s = states[:, :, 7]
    at_cap = float((iters >= ADMM_RTI["qp_max_iter"]).double().mean())
    print(f"ADMM RTI (K4 + K5) {BATCH} x {ADMM_TICKS} ticks on {card}: all "
          f"ok; median tick {med * 1e3:.3f} ms (first "
          f"{times[0] * 1e3:.1f} ms), {BATCH / med:.1f} solves/s; mean ADMM "
          f"iterations per lane-tick {iters.double().mean():.2f}, at the "
          f"cap {at_cap:.3f} of lane-ticks; s {float(s[0].mean()):.5f} -> "
          f"{float(s[-1].mean()):.5f}; launches {launches}")
    return states, inputs, launches


def phase_admm_converged(problem, x0, card):
    """The converged ADMM mode and its three options; K5 launches against
    the SQP iterations run (2 per iteration, 4 with SOC)."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    runs = [("ADMM converged", dict(), 2),
            ("ADMM converged + BFGS", dict(use_BFGS=True), 2),
            ("ADMM converged + SOC", dict(do_SOC=True), 4),
            ("ADMM converged + merit", dict(line_search="merit"), 2)]
    for label, change, per_iter in runs:
        reset_counts()
        times, oks, states, iters, sqp_iters, _ = closed_loop(
            problem, x0, OPTION_TICKS, SQPConfig(**ADMM_CONVERGED, **change))
        launches = read_counts()
        check_ok(label, oks, states)
        run_iters = int(sqp_iters.max(1).values.sum())
        want = dict(K1=0, K2=0, K3=0, K4=OPTION_TICKS,
                    K5=per_iter * run_iters, K6=OPTION_TICKS,
                    K7=2 * OPTION_TICKS)
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{want} for {run_iters} SQP iterations")
        print(f"{label} {BATCH} x {OPTION_TICKS} ticks on {card}: all ok; "
              f"SQP iterations per lane-tick mean "
              f"{sqp_iters.double().mean():.3f}, max {int(sqp_iters.max())};"
              f" {run_iters} run; mean ADMM iterations per lane-tick "
              f"{iters.double().mean():.2f}; median tick "
              f"{statistics.median(times[1:]) * 1e3:.3f} ms; launches "
              f"{launches}")


def envelope_gaps(label, states, states_gpu, dof: int = 7) -> dict:
    """The float64 states' largest gaps to the GPU run's over q (all dof
    joints), s and vs, held to the envelope."""
    d = (states - states_gpu.to(torch.float64)).abs()
    gaps = {"q": float(d[..., :dof].max()), "s": float(d[..., dof].max()),
            "vs": float(d[..., dof + 1].max())}
    print(f"CPU float64 cross-check ({label}), {d.shape[1]} lanes x "
          f"{d.shape[0]} ticks: max |dq| {gaps['q']:.3e}, |ds| "
          f"{gaps['s']:.3e}, |dvs| {gaps['vs']:.3e} (envelope {ENVELOPE})")
    for k, v in gaps.items():
        if not v < ENVELOPE[k]:
            raise AssertionError(f"CPU float64 check ({label}): |d {k}| "
                                 f"{v:.3e} >= {ENVELOPE[k]}")
    return gaps


def phase_cpu_check_rti(x0_gpu, states_gpu):
    """The RTI loop, closed loop from the same states."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    problem64 = build_problem(torch.float64, "cpu")
    x0 = x0_gpu[:CHECK_LANES].cpu().to(torch.float64)
    _, oks, states, _, _, _ = closed_loop(problem64, x0, CHECK_TICKS,
                                          SQPConfig())
    if not bool(oks.all()):
        raise AssertionError("CPU float64 check (RTI): a lane was not ok")
    envelope_gaps("RTI, closed loop", states,
                  states_gpu[:CHECK_TICKS, :CHECK_LANES])


def phase_cpu_check_mehrotra(x0_gpu, inputs, states_gpu, iters_gpu,
                             solves):
    """The Mehrotra RTI loop against float64.  On some QPs of this loop a
    float32 Mehrotra solve, the plain version's as well as the kernel's,
    ends after another number of Newton iterations than float64's, and
    there its input step lands up to ~0.04 away (ROADMAP section 3).  So:

    * every lane of every K1 call of the GPU run, on that call's own QP and
      warm start: the kernel's result and the plain version's float32 solve
      on the card, each against float64 on the CPU.  The kernel's Newton
      counts may differ from float64's on at most ``MEHROTRA_SPLIT_RATIO``
      times as many lanes as the plain float32 solve's, and its largest
      |d du| may be at most that ratio times the plain solve's;
    * 8 lanes tick by tick from the GPU run's inputs, every lane-tick held
      to the envelope (a lane-tick whose Newton count differs included);
    * the 8 lanes' closed loop: its gap printed, not held (a split
      lane-tick's step carries on through the later ticks)."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry, mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        solve_qp_ipm_k)
    f64 = lambda t: (t.cpu().to(torch.float64)
                     if t is not None and t.is_floating_point() else t)
    split = {"kernel": 0, "plain": 0}
    gap = {"kernel": 0.0, "plain": 0.0}
    lanes, plain_split = 0, []
    for t, (rep, kw, sol) in enumerate(solves):
        # K1's plain version, named (interpret=True): on the card in
        # float32, and on the CPU in float64
        plain = solve_qp_ipm_k(rep, **dict(kw, interpret=True))
        ref = solve_qp_ipm_k(
            type(rep)(**{f.name: f64(getattr(rep, f.name))
                         for f in dataclasses.fields(rep)}),
            **dict(kw, warm_s=f64(kw["warm_s"]), warm_lam=f64(kw["warm_lam"]),
                   interpret=True))
        for name, got in (("kernel", sol), ("plain", plain)):
            split[name] += int((got.iters.cpu() != ref.iters).sum())
            gap[name] = max(gap[name], float((f64(got.du) - ref.du).abs().max()))
        lanes += ref.iters.numel()
        its = [x.iters.cpu() for x in (sol, plain, ref)]
        plain_split += [(t, ln, *(int(i[ln]) for i in its))
                        for ln in (its[1] != its[2]).nonzero()[:, 0].tolist()]
    print(f"CPU float64, Mehrotra RTI, every lane of K1's {len(solves)} "
          f"solves ({lanes} QPs): Newton iterations differ from float64 on "
          f"{split['kernel']} (kernel) and {split['plain']} (plain float32 "
          f"on the card); max |d du| {gap['kernel']:.3e} and "
          f"{gap['plain']:.3e}")
    print(f"  (tick, lane, Newton iterations of the kernel, the plain float32 "
          f"solve, float64) where the plain solve differs from float64, first "
          f"10: {plain_split[:10]}")
    if split["kernel"] > MEHROTRA_SPLIT_RATIO * split["plain"] \
            or not gap["kernel"] <= MEHROTRA_SPLIT_RATIO * gap["plain"]:
        raise AssertionError(
            f"CPU float64 check (Mehrotra RTI): the kernel is further from "
            f"float64 than {MEHROTRA_SPLIT_RATIO}x the plain float32 solve")

    cfg = SQPConfig(**MEHROTRA_RTI)
    problem64 = build_problem(torch.float64, "cpu")
    obs = torch.tensor([[3.0, 3.0, 3.0]] * CHECK_LANES, dtype=torch.float64)
    rad = torch.zeros(CHECK_LANES, dtype=torch.float64)
    states, iters = [], []
    for x, u, carry in inputs[:CHECK_TICKS]:
        carry64 = MPCCarry(**{f.name: f64(getattr(carry, f.name))
                              for f in dataclasses.fields(MPCCarry)})
        _, out = mpc_step(*problem64, carry64, f64(x), f64(u), obs, rad,
                          ts=TS, cfg=cfg)
        if not bool(out.ok.all()):
            raise AssertionError("CPU float64 check (Mehrotra RTI): a lane "
                                 "was not ok")
        states.append(sim_time_step(out.x0_updated, out.u0, TS))
        iters.append(out.qp_iters)
    split_at = (torch.stack(iters)
                != iters_gpu[:CHECK_TICKS, :CHECK_LANES]).nonzero().tolist()
    print(f"  Mehrotra RTI tick by tick, (tick, lane) whose Newton "
          f"iterations differ from float64: {split_at or 'none'}")
    envelope_gaps("Mehrotra RTI, tick by tick", torch.stack(states),
                  states_gpu[:CHECK_TICKS, :CHECK_LANES])
    _, _, closed, _, _, _ = closed_loop(
        problem64, x0_gpu[:CHECK_LANES].cpu().to(torch.float64), CHECK_TICKS,
        cfg)
    d = (closed - states_gpu[:CHECK_TICKS, :CHECK_LANES].to(torch.float64)
         ).abs()
    print(f"CPU float64, Mehrotra RTI closed loop, {CHECK_LANES} lanes x "
          f"{CHECK_TICKS} ticks: max |dq| {float(d[..., :7].max()):.3e}, "
          f"|ds| {float(d[..., 7].max()):.3e}, |dvs| "
          f"{float(d[..., 8].max()):.3e} (not held)")


def phase_cpu_check_converged(inputs, states_gpu):
    """The converged loop, tick by tick: each float64 tick starts from the
    GPU run's state, input and carry of that tick.  (Closed loop the two
    drift apart: from the second SQP iteration on, the filter compares
    violations that are roundoff -- ~1e-16 in float64, ~1e-7 in float32 --
    so the two precisions accept different steps; measured on the CPU,
    float32 against float64 on 8 lanes x 5 ticks: |dq| 9.0e-4, |ds| 5.9e-4,
    |dvs| 2.7e-2, against 4.7e-4, 5.2e-7, 1.0e-4 tick by tick.)"""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry, mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    problem64 = build_problem(torch.float64, "cpu")
    f64 = lambda t: t.to(torch.float64) if t.is_floating_point() else t
    obs = torch.tensor([[3.0, 3.0, 3.0]] * CHECK_LANES, dtype=torch.float64)
    rad = torch.zeros(CHECK_LANES, dtype=torch.float64)
    states = []
    for x, u, carry in inputs[:CONV_CHECK_TICKS]:
        carry64 = MPCCarry(**{f.name: f64(getattr(carry, f.name))
                              for f in dataclasses.fields(MPCCarry)})
        _, out = mpc_step(*problem64, carry64, f64(x), f64(u), obs, rad,
                          ts=TS, cfg=SQPConfig(**CONVERGED))
        if not bool(out.ok.all()):
            raise AssertionError("CPU float64 check (converged): a lane was "
                                 "not ok")
        states.append(sim_time_step(out.x0_updated, out.u0, TS))
    envelope_gaps("converged, tick by tick", torch.stack(states),
                  states_gpu[:CONV_CHECK_TICKS, :CHECK_LANES])


def phase_cpu_check_admm(inputs, states_gpu):
    """The ADMM RTI loop tick by tick from the GPU run's inputs (state,
    input, carry with the ADMM warm start): the float64 plain ``"xla"``
    ADMM route held to the envelope; the float32 plain K5 route beside it
    (its gap to float64 printed, measured in this run)."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry, mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    out_states = {}
    for dtype, backend in ((torch.float64, "xla"), (torch.float32, "pallas")):
        problem = build_problem(dtype, "cpu")
        cast = lambda t: t.to(dtype) if t.is_floating_point() else t
        obs = torch.tensor([[3.0, 3.0, 3.0]] * CHECK_LANES, dtype=dtype)
        rad = torch.zeros(CHECK_LANES, dtype=dtype)
        cfg = SQPConfig(**dict(ADMM_RTI, qp_backend=backend))
        states = []
        for x, u, carry in inputs:
            c = MPCCarry(**{f.name: cast(getattr(carry, f.name))
                            for f in dataclasses.fields(MPCCarry)})
            _, out = mpc_step(*problem, c, cast(x), cast(u), obs, rad, ts=TS,
                              cfg=cfg)
            if not bool(out.ok.all()):
                raise AssertionError(f"CPU check (ADMM RTI, {dtype}): a "
                                     "lane was not ok")
            states.append(sim_time_step(out.x0_updated, out.u0, TS))
        out_states[backend] = torch.stack(states).to(torch.float64)
    d = (out_states["pallas"] - out_states["xla"]).abs()
    print(f"CPU, ADMM RTI tick by tick: float32 plain K5 route against the "
          f"float64 'xla' route: max |dq| {float(d[..., :7].max()):.3e}, "
          f"|ds| {float(d[..., 7].max()):.3e}, |dvs| "
          f"{float(d[..., 8].max()):.3e}")
    envelope_gaps("ADMM RTI, tick by tick", out_states["xla"],
                  states_gpu[:len(inputs), :CHECK_LANES])


# ------------------------------------------------------------ Husky+Panda


def mobile_system():
    from mpcc_manipulator_tpu_torch.system import HUSKY_PANDA
    return HUSKY_PANDA


def both_batches(label, fn, reps, plain_fn, plain_reps, symbol) -> dict:
    """``fn(batch)`` (the wrapper of the kernel named ``symbol``) and
    ``plain_fn(batch)`` timed at each of ``MOBILE_BATCHES``: {batch:
    :func:`kernel_times` with ``plain_ms``}."""
    out = {}
    for b in MOBILE_BATCHES:
        t = kernel_times(lambda: fn(b), symbol, reps)
        t["plain_ms"] = cuda_time(lambda: plain_fn(b), plain_reps)
        out[b] = t
        print(f"{label} at batch {b}: {times_text(t)}, plain "
              f"{t['plain_ms']:.4f} ms")
    return out


def mobile_entry(name, source, replaces, err, times, bounds) -> dict:
    """A kernel record at the first of ``MOBILE_BATCHES`` (the times, the
    bound) with the second's beside it."""
    b0, b1 = MOBILE_BATCHES
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "batch": b0,
            **times[b0], **bounds[b0],
            **{f"{k}_{b1}": v for k, v in times[b1].items()},
            f"bound_ms_{b1}": bounds[b1]["bound_ms"]}


def phase_k4_mobile(device) -> dict:
    """K4's Husky+Panda instantiation against its plain version at
    (4096, 11, 10): the arm's configurations as in the Panda phase, base
    poses about (0, 0, 0) with the same spread."""
    from mpcc_manipulator_tpu_torch.ops.kinematics_kernel import (
        kin_sweep, kin_sweep_plain)
    sy = mobile_system()
    rng = np.random.default_rng(SEED + 21)
    qs = torch.tensor(
        home(sy)[:sy.dof]
        + 0.3 * rng.standard_normal((MOBILE_BATCHES[0], KNOTS, sy.dof)),
        dtype=torch.float32, device=device)
    got = kin_sweep(qs, sy)
    ref = kin_sweep_plain(qs, sy)
    torch.cuda.synchronize()
    err, n_well, n_near, near = check_k4("K4-m", got, ref)
    check_k4_nan("K4-m", qs, sy)
    print_k4_launches()
    if not bool((got[5][..., :sy.base_dof] == 0).all()):
        raise AssertionError("K4-m: non-zero manipulability gradient on a "
                             "base column")
    print(f"K4-m vs plain at {tuple(qs.shape)}: max|err| {err:.3e} on "
          f"{n_well} configurations; {n_near} with m < "
          f"{K4_SINGULAR_BELOW}: max|err| m {near[0]:.3e}, dm "
          f"{near[1]:.3e}")
    part = {b: qs[:b].contiguous() for b in MOBILE_BATCHES}
    times = both_batches("K4-m", lambda b: kin_sweep(part[b], sy), 50,
                         lambda b: kin_sweep_plain(part[b], sy), 10,
                         "kin_kernel<")
    # bytes: the configurations in, the six outputs out; operations:
    # k4_flops a configuration
    bounds = {b: bound(nbytes(part[b], *kin_sweep(part[b], sy)),
                       k4_flops(sy.dof) * b * KNOTS) for b in MOBILE_BATCHES}
    return mobile_entry(
        "K4-m kinematics sweep, Husky+Panda (kin_sweep, system=HUSKY_PANDA)",
        "mpcc_manipulator_tpu_torch/csrc/kinematics.cu",
        "mpcc_manipulator_tpu/ops/pallas_kinematics.py:241", err, times,
        bounds)


def print_k1_launches() -> None:
    """K1's launch at N = 5, 10 and 20 for both systems: shared bytes,
    blocks an SM, registers, local bytes and the waves at the batches this
    script runs (ROADMAP item 13; printed, held only at N = 10)."""
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import launch_config
    from mpcc_manipulator_tpu_torch.system import PANDA
    for sy, batches in ((PANDA, (BATCH,)), (mobile_system(), MOBILE_BATCHES)):
        for n in K1_HORIZONS:
            cfg = launch_config(n, sy)
            at_once = cfg["blocks_per_sm"] * cfg["sms"]
            waves = {b: -(-b // at_once) if at_once else None
                     for b in batches}
            print(f"K1 launch, {sy.name}, N = {n}: {cfg['shared_bytes']} B "
                  f"shared, {cfg['blocks_per_sm']} blocks an SM "
                  f"({at_once} scenarios at once), {cfg['registers']} "
                  f"registers, {cfg['local_bytes']} B local; waves {waves}")


def print_k23_launches() -> None:
    """K2's and K3's launch (one and five candidates) at N = 5, 10 and 20
    for both systems, at the batches this script runs: the card's report
    (`mpcc_assembly_launch_config`) held equal to the Python mirror
    (`launch_geometry`), no local memory (stack or spill), shared memory
    within 48 KB and at least one block an SM for every SM at the Panda's
    batch."""
    from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
    from mpcc_manipulator_tpu_torch.system import PANDA
    for sy, batch in ((PANDA, BATCH), (mobile_system(), MOBILE_BATCHES[0])):
        for n in K1_HORIZONS:
            for kernel, cand in ((2, 1), (3, 1), (3, CANDIDATES)):
                cfg = ak.launch_config(kernel, sy, n, cand, batch)
                mirror = ak.launch_geometry(kernel, sy, n, cand, batch)
                name = f"K{kernel}" + (f" x{cand}" if cand > 1 else "")
                print(f"{name} launch, {sy.name}, N = {n}, batch {batch}: "
                      f"{cfg['scenarios_per_block']} scenarios ("
                      f"{cfg['rows_per_block']} rows) a block, "
                      f"{cfg['threads']} threads, {cfg['shared_bytes']} B "
                      f"shared, {cfg['blocks']} blocks, "
                      f"{cfg['blocks_per_sm']} blocks an SM, "
                      f"{cfg['registers']} registers, {cfg['local_bytes']} "
                      f"B local")
                if any(cfg[k] != v for k, v in mirror.items()):
                    raise AssertionError(f"{name} launch at N = {n}: the card "
                                         f"reports {cfg}, the mirror "
                                         f"{mirror}")
                if cfg["local_bytes"] or cfg["shared_bytes"] > 48 * 1024 \
                        or cfg["blocks_per_sm"] < 1 or (
                            sy is PANDA and cfg["blocks"] < cfg["sms"]):
                    raise AssertionError(f"{name} launch at N = {n}: {cfg}")


def phase_k1_mobile(mproblem, device) -> dict:
    """K1's Husky+Panda instantiation in both schemes, cold and warm,
    against its plain version on the StageQPK of 4096 perturbed mobile home
    states, under tests/test_qp_ipm_pallas_mobile.py's contract; a NaN
    lane; the launch configuration; the warm solves timed at both
    batches."""
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        launch_config, solve_qp_ipm_k, solve_qp_ipm_plain)
    sy = mobile_system()
    nb = MOBILE_BATCHES[0]
    print_k1_launches()
    print_k23_launches()
    cfg = launch_config(KNOTS - 1, sy)
    at_once = cfg["blocks_per_sm"] * cfg["sms"]
    waves = {b: -(-b // at_once) for b in MOBILE_BATCHES} if at_once else {}
    print(f"K1-h launch, both schemes (one kernel): {cfg}; {at_once} "
          f"scenarios at once; waves {waves}")
    if cfg["local_bytes"] or cfg["blocks_per_sm"] < K1_BLOCKS_PER_SM \
            or cfg["shared_bytes"] > K1_SMEM_BUDGET:
        raise AssertionError(
            f"K1-h at N = {KNOTS - 1}: {cfg['local_bytes']} B of local "
            f"memory, {cfg['blocks_per_sm']} blocks an SM, "
            f"{cfg['shared_bytes']} B of shared memory: the budget is no "
            f"local memory, {K1_BLOCKS_PER_SM} blocks an SM and "
            f"{K1_SMEM_BUDGET} B")
    qpk = stage_qp_batch(mproblem, device, sy, nb)
    err, times, bounds = 0.0, {}, {}
    part = lambda t, b: t[:b].contiguous()
    for scheme in ("adaptive", "mehrotra"):
        cold = solve_qp_ipm_k(qpk, system=sy, scheme=scheme)
        cold_ref = solve_qp_ipm_plain(qpk, system=sy, scheme=scheme)
        torch.cuda.synchronize()
        err = max(err, compare_ipm(f"Husky {scheme} cold", cold, cold_ref,
                                   MOBILE_IPM_TOL, duals=False))
        ws = torch.clamp(cold_ref.s_rows, 0.1, 100.0)
        wl = torch.clamp(cold_ref.lam_rows, 0.1, 100.0)
        warm = solve_qp_ipm_k(qpk, warm_s=ws, warm_lam=wl, system=sy,
                              scheme=scheme)
        warm_ref = solve_qp_ipm_plain(qpk, warm_s=ws, warm_lam=wl,
                                      system=sy, scheme=scheme)
        torch.cuda.synchronize()
        err = max(err, compare_ipm(f"Husky {scheme} warm", warm, warm_ref,
                                   MOBILE_IPM_TOL, duals=False))
        qpk_nan = dataclasses.replace(qpk, hxx=qpk.hxx.clone())
        qpk_nan.hxx[K1_NAN_LANE, 3, 2, 2] = float("nan")
        dirty = solve_qp_ipm_k(qpk_nan, warm_s=ws, warm_lam=wl, system=sy,
                               scheme=scheme)
        torch.cuda.synchronize()
        keep = torch.ones(nb, dtype=torch.bool, device=device)
        keep[K1_NAN_LANE] = False
        fields = ("dx_tilde", "du", "lam", "s_rows", "iters", "solved", "mu")
        if bool(dirty.solved[K1_NAN_LANE]) or not all(
                torch.equal(getattr(dirty, f)[keep], getattr(warm, f)[keep])
                for f in fields):
            raise AssertionError(f"K1-h {scheme} NaN lane: solved, or another "
                                 "lane changed")
        print(f"K1-h {scheme}, NaN in hxx of lane {K1_NAN_LANE}: not solved, "
              f"the other {nb - 1} lanes bit-identical")
        qb = {b: (qpk if b == nb else type(qpk)(**{
            f.name: part(getattr(qpk, f.name), b)
            for f in dataclasses.fields(qpk)}), part(ws, b), part(wl, b))
              for b in MOBILE_BATCHES}
        solve = lambda b: solve_qp_ipm_k(qb[b][0], warm_s=qb[b][1],
                                         warm_lam=qb[b][2], system=sy,
                                         scheme=scheme)
        plain = lambda b: solve_qp_ipm_plain(qb[b][0], warm_s=qb[b][1],
                                             warm_lam=qb[b][2], system=sy,
                                             scheme=scheme)
        times[scheme] = both_batches(f"K1-h {scheme} warm solve", solve, 20,
                                     plain, 2, "ipm_kernel<")
        print(f"K1-h {scheme} warm solve before its redesign (batch "
              f"{' / '.join(map(str, MOBILE_BATCHES))}): "
              f"{' / '.join(map(str, K1H_BEFORE_MS[scheme]))} ms (wrapper)")
        bounds[scheme] = {}
        for b in MOBILE_BATCHES:
            sol = solve(b)
            ins = [getattr(qb[b][0], f.name)
                   for f in dataclasses.fields(qpk)]
            outs = [sol.dx_tilde, sol.du, sol.lam, sol.s_rows, sol.iters,
                    sol.solved, sol.mu]
            bounds[scheme][b] = bound(
                nbytes(*ins, qb[b][1], qb[b][2], *outs),
                k1_flops(scheme, sol.iters, sy))
            print(f"K1-h {scheme} warm at batch {b}: mean "
                  f"{sol.iters.double().mean():.3f} iterations; bound "
                  f"{bounds[scheme][b]['bound_ms']:.4f} ms "
                  f"({bounds[scheme][b]['bound_by']})")
    entry = mobile_entry(
        "K1-h interior-point QP solve, Husky+Panda (solve_qp_ipm_k, "
        "system=HUSKY_PANDA)", "mpcc_manipulator_tpu_torch/csrc/qp_ipm.cu",
        "mpcc_manipulator_tpu/solver/qp_ipm_pallas.py:64", err,
        times["adaptive"], bounds["adaptive"])
    entry.update(registers=cfg["registers"], local_bytes=cfg["local_bytes"],
                 shared_bytes=cfg["shared_bytes"],
                 blocks_per_sm=cfg["blocks_per_sm"], waves=waves,
                 mehrotra_ms=times["mehrotra"][nb]["ms"],
                 mehrotra_wrapper_ms=times["mehrotra"][nb]["wrapper_ms"],
                 mehrotra_plain_ms=times["mehrotra"][nb]["plain_ms"],
                 mehrotra_bound_ms=bounds["mehrotra"][nb]["bound_ms"])
    return entry


def phase_k23_mobile(mproblem, device) -> list:
    """K2's and K3's Husky+Panda instantiations against their plain
    versions at 4096 lanes on the mobile track: the first tick's iterate
    and 0.02-perturbed trial points, one and five candidates, and each
    cost term alone; both timed at both batches."""
    from mpcc_manipulator_tpu_torch.ops import assembly_kernel as ak
    sy = mobile_system()
    nb = MOBILE_BATCHES[0]
    track, params = mproblem[:2]
    z, zt, zc, cu, rb = main_path_inputs(mproblem, device, sy, nb)
    singles = single_term_params(mproblem, device, sy, nb)
    err2 = 0.0
    cases = [("iterate", params, z), ("trial", params, zt)] + [
        (f"trial, {w} alone", p_w, zt) for w, p_w in singles]
    for label, p, zz in cases:
        got = ak.build_qp_stages_k_kernel(track, zz, rb, p, cu, TS,
                                          system=sy)
        ref = ak.build_qp_stages_k_plain(track, zz, rb, p, cu, TS, system=sy)
        torch.cuda.synchronize()
        err2 = max(err2, check_k2(f"K2-h {label}", got, ref))
    err3 = 0.0
    cases = [("trial", params, zt), (f"x{CANDIDATES} candidates", params, zc)
             ] + [(f"trial, {w} alone", p_w, zt) for w, p_w in singles]
    for label, p, zz in cases:
        err3 = max(err3, check_k3(
            f"Husky {label}",
            ak.eval_point_kernel(track, zz, rb, p, cu, TS, sy),
            ak.eval_point_plain(track, zz, rb, p, cu, TS, sy)))
    # N = 5 and N = 20 at batch 1024
    for label, syn, zn, ztn, zcn, cun, rbn in horizon_cases(
            mproblem, device, sy, MOBILE_BATCHES[1]):
        err2 = max(err2, check_k2(
            f"K2-h {label}",
            ak.build_qp_stages_k_kernel(track, zn, rbn, params, cun, TS,
                                        system=syn),
            ak.build_qp_stages_k_plain(track, zn, rbn, params, cun, TS,
                                       system=syn)))
        for what, zz in (("trial", ztn), (f"x{CANDIDATES}", zcn)):
            err3 = max(err3, check_k3(
                f"Husky {label} {what}",
                ak.eval_point_kernel(track, zz, rbn, params, cun, TS, syn),
                ak.eval_point_plain(track, zz, rbn, params, cun, TS, syn)))
    sub = {b: (z[:b].contiguous(), zt[:b].contiguous(), cu[:b].contiguous(),
               type(rb)(**{f.name: getattr(rb, f.name)[:b]
                           for f in dataclasses.fields(rb)}))
           for b in MOBILE_BATCHES}
    t2 = both_batches(
        "K2-h assembly",
        lambda b: ak.build_qp_stages_k_kernel(track, sub[b][0], sub[b][3],
                                              params, sub[b][2], TS,
                                              system=sy), 50,
        lambda b: ak.build_qp_stages_k_plain(track, sub[b][0], sub[b][3],
                                             params, sub[b][2], TS,
                                             system=sy), 5, "assembly_kernel<")
    t3 = both_batches(
        "K3-h evaluation",
        lambda b: ak.eval_point_kernel(track, sub[b][1], sub[b][3], params,
                                       sub[b][2], TS, sy), 50,
        lambda b: ak.eval_point_plain(track, sub[b][1], sub[b][3], params,
                                      sub[b][2], TS, sy), 5, "eval_kernel<")
    table = ak.pack_tables(track, params, TS, sy)
    b2, b3 = {}, {}
    for b in MOBILE_BATCHES:
        zz, zzt, cc, rr = sub[b]
        got = ak.build_qp_stages_k_kernel(track, zz, rr, params, cc, TS,
                                          system=sy)
        b2[b] = bound(nbytes(zz, cc, *(getattr(rr, f) for f in ak._K2_ROBOT),
                             table, *(getattr(got, f) for f in ak._K2_OUT)),
                      3e3 * b * KNOTS)
        b3[b] = bound(nbytes(zzt, cc, *(getattr(rr, f)
                                        for f in ak._K3_ROBOT), table)
                      + 8 * b, 1.5e3 * b * KNOTS)
    src = "mpcc_manipulator_tpu_torch/csrc/assembly.cu"
    return [mobile_entry("K2-h stage-QP assembly, Husky+Panda "
                         "(build_qp_stages_k_kernel, system=HUSKY_PANDA)",
                         src, "mpcc_manipulator_tpu/ops/pallas_assembly.py:290",
                         err2, t2, b2),
            mobile_entry("K3-h line-search evaluation, Husky+Panda "
                         "(eval_point_kernel, system=HUSKY_PANDA)", src,
                         "mpcc_manipulator_tpu/ops/pallas_assembly.py:756",
                         err3, t3, b3)]


def phase_mobile_rti(mproblem, device, card) -> dict:
    """The Husky+Panda RTI path (`mpc_step(system=HUSKY_PANDA)` under
    ``SQPConfig()``, K1-K4) + the plant step: ``MOBILE_TICKS`` ticks at each
    of ``MOBILE_BATCHES``, the counts set to 0 just before each run and
    read just after.  Every lane ok every tick, finite states, s rising
    after the start transient, the mean base x growing, K1-K4 once per
    tick.  Returns the first run's launches, states and recorded inputs."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    sy = mobile_system()
    first = None
    for b in MOBILE_BATCHES:
        x0 = perturbed_states(b, torch.float32, device, sy)
        reset_counts()
        times, oks, states, iters, _, inputs = closed_loop(
            mproblem, x0, MOBILE_TICKS, SQPConfig(),
            record=CHECK_LANES if first is None else 0, system=sy)
        launches = read_counts()
        check_ok(f"Husky RTI, batch {b}", oks, states)
        s = states[:, :, sy.s_idx]
        xb = states[:, :, 0].double().mean(1)
        back = (s[1:] <= s[:-1]).sum(1)
        if not bool((s[MOBILE_S_RISING_FROM + 1:]
                     > s[MOBILE_S_RISING_FROM:-1]).all()) \
                or not bool((s[-1] > s[0]).all()):
            raise AssertionError(
                f"Husky RTI, batch {b}: s not strictly increasing after "
                f"tick {MOBILE_S_RISING_FROM}; non-increasing lanes per tick "
                f"{back.tolist()}")
        if not bool((xb[1:] > xb[:-1]).all()):
            raise AssertionError(f"Husky RTI, batch {b}: the mean base x "
                                 f"does not grow: {xb.tolist()}")
        want = dict(K1=MOBILE_TICKS, K2=MOBILE_TICKS, K3=MOBILE_TICKS,
                    K4=MOBILE_TICKS, K5=0, K6=MOBILE_TICKS,
                    K7=2 * MOBILE_TICKS)
        if launches != want:
            raise AssertionError(f"Husky RTI, batch {b}: launches "
                                 f"{launches}, expected {want}")
        tick_ms = np.asarray(times[1:]) * 1e3
        med, p99 = float(np.median(tick_ms)), float(np.percentile(tick_ms,
                                                                  99))
        print(f"Husky+Panda RTI (K1-K4) {b} x {MOBILE_TICKS} ticks on {card}: "
              f"all ok; median tick {med:.3f} ms, p99 {p99:.3f} ms (of "
              f"{tick_ms.size} ticks; first {times[0] * 1e3:.1f} ms), "
              f"{b / med * 1e3:.1f} solves/s; mean IPM iters "
              f"{iters.float().mean():.2f}, max {int(iters.max())}; "
              f"non-increasing s lane-ticks per tick {back.tolist()}; s "
              f"{float(s[0].mean()):.5f} -> {float(s[-1].mean()):.5f}; mean "
              f"x_b {float(xb[0]):.5f} -> {float(xb[-1]):.5f}; launches "
              f"{launches}")
        if first is None:
            first = dict(launches=launches, states=states, inputs=inputs,
                         iters=iters)
    return first


def phase_cpu_check_mobile(inputs, states_gpu, iters_gpu):
    """The Husky+Panda RTI loop tick by tick from the GPU run's inputs
    (state, input, carry) for ``CHECK_LANES`` lanes, through the plain path
    in float64 on the CPU, every lane-tick held to the envelope (q over
    all 10 joints)."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry, mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    sy = mobile_system()
    problem64 = build_problem(torch.float64, "cpu", system=sy)
    f64 = lambda t: t.to(torch.float64) if t.is_floating_point() else t
    obs = torch.tensor([[3.0, 3.0, 3.0]] * CHECK_LANES, dtype=torch.float64)
    rad = torch.zeros(CHECK_LANES, dtype=torch.float64)
    states, iters = [], []
    for x, u, carry in inputs:
        carry64 = MPCCarry(**{f.name: f64(getattr(carry, f.name))
                              for f in dataclasses.fields(MPCCarry)})
        _, out = mpc_step(*problem64, carry64, f64(x), f64(u), obs, rad,
                          ts=TS, cfg=SQPConfig(), system=sy)
        if not bool(out.ok.all()):
            raise AssertionError("CPU float64 check (Husky RTI): a lane was "
                                 "not ok")
        states.append(sim_time_step(out.x0_updated, out.u0, TS))
        iters.append(out.qp_iters)
    split_at = (torch.stack(iters)
                != iters_gpu[:, :CHECK_LANES]).nonzero().tolist()
    print(f"  Husky RTI tick by tick, (tick, lane) whose Newton iterations "
          f"differ from float64: {split_at or 'none'}")
    envelope_gaps("Husky+Panda RTI, tick by tick", torch.stack(states),
                  states_gpu[:, :CHECK_LANES], dof=sy.dof)


# ------------------------------------------------------------ the surfaces


def verify_recipe(gpu, cpu, ticks: int, label: str, card: str,
                  want: dict) -> dict:
    """``ticks`` ticks of the verify recipe (home state, the repo's track,
    the RK4 plant in float64 on the host) through ``gpu.runMPC`` on the
    card, the counts set to 0 just before and read just after; every tick
    ok and s strictly increasing, the launches ``want``.  Then each tick
    again on ``cpu`` (`MPCC(device="cpu")`, float64) from the card's state,
    input and carry of that tick, the plant states held to the envelope.
    Returns the card's tick times (ms) and the last state, input and
    carry."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry
    plant = lambda x, u: sim_time_step(
        torch.tensor(x, dtype=torch.float64)[None],
        torch.tensor(u, dtype=torch.float64)[None], TS)[0].numpy()
    snapshot = lambda c: MPCCarry(**{
        f.name: getattr(c, f.name).cpu() for f in dataclasses.fields(c)})
    x, u = home(), np.zeros(8)
    inputs, states, ticks_ms, oks, iters = [], [], [], [], []
    reset_counts()
    for _ in range(ticks):
        inputs.append((x, u, snapshot(gpu._carry)))
        ok, x_upd, u, _, ct = gpu.runMPC(x, u)
        x = plant(x_upd, u)
        oks.append(ok)
        states.append(x)
        ticks_ms.append(ct["total"] * 1e3)
        iters.append((ct["sqp_iters"], ct["qp_iters"]))
    launches = read_counts()
    s = np.array([st[7] for st in states])
    if not all(oks) or not np.isfinite(states).all():
        raise AssertionError(f"{label}: not ok at ticks "
                             f"{[t for t, o in enumerate(oks) if not o]}")
    if not (np.diff(s) > 0).all():
        raise AssertionError(f"{label}: s not strictly increasing: {s}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    f64 = lambda t: t.to(torch.float64) if t.is_floating_point() else t
    ref = []
    for x_in, u_in, carry in inputs:
        cpu._carry = MPCCarry(**{f.name: f64(getattr(carry, f.name))
                                 for f in dataclasses.fields(carry)})
        ok, x_upd, u_out, _, _ = cpu.runMPC(x_in, u_in)
        if not ok:
            raise AssertionError(f"{label}: the CPU float64 tick not ok")
        ref.append(plant(x_upd, u_out))
    gaps = envelope_gaps(f"{label}, tick by tick",
                         torch.tensor(np.stack(ref))[:, None],
                         torch.tensor(np.stack(states))[:, None])
    med, p99 = (float(np.median(ticks_ms[1:])),
                float(np.percentile(ticks_ms[1:], 99)))
    print(f"{label}, batch 1 x {ticks} ticks on {card}: all ok; s "
          f"{s[0]:.5f} -> {s[-1]:.5f}, strictly increasing; tick median "
          f"{med:.3f} ms, p99 {p99:.3f} ms (of {len(ticks_ms) - 1} ticks; "
          f"first {ticks_ms[0]:.1f} ms) against Ts = {TS * 1e3:.0f} ms; "
          f"(SQP, QP) iterations a tick {iters}; launches {launches}")
    return dict(median_ms=med, p99_ms=p99, launches=launches, gaps=gaps,
                state=x, input=u)


def profiled_ticks(mpc, x, u, ticks: int, label: str, want: dict) -> dict:
    """``ticks`` more ticks with ``runMPC(profile=True)``: every tick ok,
    every phase time positive; the mean phase split printed."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.solver.sqp_debug import ComputeTime
    phases = [f.name for f in dataclasses.fields(ComputeTime)]
    sums = {}
    reset_counts()
    for _ in range(ticks):
        ok, x_upd, u, _, ct = mpc.runMPC(x, u, profile=True)
        if not ok or not all(ct[k] > 0 for k in phases):
            raise AssertionError(f"{label} profiled: ok {ok}, times {ct}")
        for k in phases:
            sums[k] = sums.get(k, 0.0) + ct[k] * 1e3 / ticks
        x = sim_time_step(torch.tensor(x_upd)[None], torch.tensor(u)[None],
                          TS)[0].numpy()
    launches = read_counts()
    if launches != want:
        raise AssertionError(f"{label} profiled: launches {launches}, "
                             f"expected {want}")
    print(f"{label}, runMPC(profile=True), mean of {ticks} ticks (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sums.items())
          + f"; launches {launches}")
    return sums


def phase_api(card) -> dict:
    """(a) ``MPCC()`` on the card in JAX's default configuration (the
    converged dense ADMM path with the plain loop, the plain kinematics with
    the finite-difference gradient, float64; of the kernels only K6, once a
    tick), and (b) ``MPCC(dtype=float32)`` with ``sqp_cfg = SQPConfig()``
    (the bench configuration at batch 1: K1-K4 and K6 once a tick); each
    held tick by tick against ``MPCC(device="cpu")`` in float64 in its
    configuration, then profiled."""
    from mpcc_manipulator_tpu_torch.api import MPCC
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    # K6 and K7 (one launch a network) on either
    none = dict(K1=0, K2=0, K3=0, K4=0, K5=0, K6=1, K7=2)
    out = {}
    for name, dtype, cfg in (("reference", torch.float64, None),
                             ("bench", torch.float32, SQPConfig())):
        gpu, cpu = MPCC(dtype=dtype), MPCC(device="cpu")
        if cfg is not None:
            gpu.sqp_cfg = cpu.sqp_cfg = cfg
        gpu.setTrack(home())
        cpu.setTrack(home())
        label = f"api.MPCC ({name} configuration, {str(dtype)[6:]})"
        per_tick = none if cfg is None else dict(none, K1=1, K2=1, K3=1, K4=1)
        want = lambda n: {k: v * n for k, v in per_tick.items()}
        run = verify_recipe(gpu, cpu, API_TICKS, label, card, want(API_TICKS))
        run["phases"] = profiled_ticks(gpu, run["state"], run["input"],
                                       API_PROFILE_TICKS, label,
                                       want(API_PROFILE_TICKS))
        out[name] = run
    return out


def cpu_tick_by_tick(label, inputs, states_gpu, iters_gpu, cfg, system):
    """A loop's ``CHECK_LANES`` lanes tick by tick from the card's inputs
    (state, input, carry) through the plain path in float64 on the CPU,
    every lane-tick held to the envelope."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import MPCCarry, mpc_step
    from mpcc_manipulator_tpu_torch.problem import build_problem
    problem64 = build_problem(torch.float64, "cpu", system=system)
    f64 = lambda t: t.to(torch.float64) if t.is_floating_point() else t
    obs = torch.tensor([[3.0, 3.0, 3.0]] * CHECK_LANES, dtype=torch.float64)
    rad = torch.zeros(CHECK_LANES, dtype=torch.float64)
    states, iters = [], []
    for x, u, carry in inputs:
        carry64 = MPCCarry(**{f.name: f64(getattr(carry, f.name))
                              for f in dataclasses.fields(MPCCarry)})
        _, out = mpc_step(*problem64, carry64, f64(x), f64(u), obs, rad,
                          ts=TS, cfg=cfg, system=system)
        if not bool(out.ok.all()):
            raise AssertionError(f"CPU float64 check ({label}): a lane was "
                                 "not ok")
        states.append(sim_time_step(out.x0_updated, out.u0, TS))
        iters.append(out.qp_iters)
    split_at = (torch.stack(iters)
                != iters_gpu[:, :CHECK_LANES]).nonzero().tolist()
    print(f"  {label} tick by tick, (tick, lane) whose Newton iterations "
          f"differ from float64: {split_at or 'none'}")
    return envelope_gaps(f"{label}, tick by tick", torch.stack(states),
                         states_gpu[:, :CHECK_LANES], dof=system.dof)


def ipm_f64_gaps(label, qpk, warm, sol, ref, system, scheme) -> dict:
    """K1's solution ``sol`` and the plain float32 solve's ``ref`` on the
    card, each against the plain solve in float64 on the CPU on the same
    QPs and warm start (ROADMAP section 3, F1), on the first
    ``F64_GAP_LANES`` lanes and the lane where the kernel and the plain
    solve differ most: the QPs whose Newton count differs from float64's
    and the largest |d du|, each; and that lane's.  Printed and
    returned."""
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        solve_qp_ipm_plain)
    lane = int((sol.du - ref.du).abs().flatten(1).amax(1).argmax())
    rows = torch.unique(torch.cat([
        torch.arange(min(F64_GAP_LANES - 1, sol.du.shape[0])),
        torch.tensor([lane])])).to(sol.du.device)
    sub = lambda r: type(r)(**{f.name: getattr(r, f.name)[rows]
                               for f in dataclasses.fields(r)})
    sol, ref, at = sub(sol), sub(ref), int((rows == lane).nonzero()[0, 0])
    f64 = lambda t: t.cpu().to(torch.float64)
    ref64 = solve_qp_ipm_plain(
        type(qpk)(**{f.name: f64(getattr(qpk, f.name)[rows])
                     for f in dataclasses.fields(qpk)}),
        system=system, scheme=scheme,
        **{k: f64(v[rows]) for k, v in warm.items()})
    out = {name: (int((got.iters.cpu() != ref64.iters).sum()),
                  float((f64(got.du) - ref64.du).abs().max()))
           for name, got in (("kernel", sol), ("plain", ref))}
    dist = lambda a, b: float((f64(a.du[at]) - f64(b.du[at])).abs().max())
    print(f"  {label} against float64 on the CPU: Newton counts differ on "
          f"{out['kernel'][0]} (kernel) and {out['plain'][0]} (plain "
          f"float32) of {ref64.iters.numel()} QPs, max |d du| "
          f"{out['kernel'][1]:.3e} and {out['plain'][1]:.3e}; lane {lane} "
          f"(kernel and plain furthest apart): iterations "
          f"{int(sol.iters[at])} / {int(ref.iters[at])} / "
          f"{int(ref64.iters[at])} (kernel / plain / float64), |d du| "
          f"kernel-plain {dist(sol, ref):.3e}, kernel-float64 "
          f"{dist(sol, ref64):.3e}, plain-float64 {dist(ref, ref64):.3e}")
    return out


def compare_ipm_split(label, qpk, warm, sol, ref, system, scheme, step_tol,
                      duals) -> int:
    """K1's solution against its plain version's at another horizon: the
    contract of :func:`compare_ipm` (iteration counts within +-1, identical
    verdicts, steps within ``step_tol``, the duals as there) on every lane
    where the two end on the same Newton count.  Where they end one
    iteration apart, the stop test (mu < 1e-5, residual < 2e-4) flipped
    under float32 rounding (ROADMAP section 3, F1): there the solve that
    stopped first must have met the test (mu < 1e-5), and the kernel's
    iterate is held to the float64 solve stopped after the kernel's own
    count of iterations: within ``step_tol``, or, as F1 holds K1 on the
    near-flat QPs, no further from it than ``MEHROTRA_SPLIT_RATIO`` times
    the plain float32 solve stopped there; the lane is printed.  Returns the
    number of such lanes."""
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        solve_qp_ipm_plain)
    d_it = int((sol.iters - ref.iters).abs().max())
    if d_it > 1 or not bool((sol.solved == ref.solved).all()):
        raise AssertionError(f"K1 {label}: iteration counts differ by {d_it}"
                             f" or verdicts differ")
    same = sol.iters == ref.iters
    pick = lambda r, m: type(r)(**{f.name: getattr(r, f.name)[m]
                                   for f in dataclasses.fields(r)})
    compare_ipm(f"{label}, {int(same.sum())} lanes on the plain solve's "
                f"count", pick(sol, same), pick(ref, same), step_tol, duals)
    lanes = (~same).nonzero()[:, 0].tolist()
    f64 = lambda t: t.cpu().to(torch.float64)
    for lane in lanes:
        early = sol if int(sol.iters[lane]) < int(ref.iters[lane]) else ref
        if not float(early.mu[lane]) < K1_EPS_IPM:
            raise AssertionError(f"K1 {label} lane {lane}: the solve that "
                                 f"stopped first did not meet the stop test "
                                 f"(mu {float(early.mu[lane]):.4e})")
        one = torch.tensor([lane], device=sol.du.device)
        k = int(sol.iters[lane])
        lane_qp = type(qpk)(**{f.name: getattr(qpk, f.name)[one]
                               for f in dataclasses.fields(qpk)})
        lane_warm = {key: v[one] for key, v in warm.items()}
        ref64 = solve_qp_ipm_plain(
            type(qpk)(**{f.name: f64(getattr(lane_qp, f.name))
                         for f in dataclasses.fields(qpk)}),
            max_iter=k, system=system, scheme=scheme,
            **{key: f64(v) for key, v in lane_warm.items()})
        plain_k = solve_qp_ipm_plain(lane_qp, max_iter=k, system=system,
                                     scheme=scheme, **lane_warm)
        gap = lambda a: max(float((f64(a.du) - ref64.du).abs().max()),
                            float((f64(a.dx_tilde)
                                   - ref64.dx_tilde).abs().max()))
        e_kernel, e_plain = gap(pick(sol, one)), gap(plain_k)
        print(f"  K1 {label}, lane {lane}: {k} Newton iterations (the plain "
              f"float32 solve {int(ref.iters[lane])}); mu at the stop "
              f"{float(sol.mu[lane]):.4e} (float64 after as many "
              f"{float(ref64.mu[0]):.4e}, the test's bound {K1_EPS_IPM}); "
              f"|d du, d dx| to that float64 iterate: kernel {e_kernel:.3e}, "
              f"the plain float32 solve stopped there {e_plain:.3e}")
        if not e_kernel <= max(step_tol, MEHROTRA_SPLIT_RATIO * e_plain):
            raise AssertionError(
                f"K1 {label} lane {lane}: {e_kernel:.3e} from the float64 "
                f"iterate, above {step_tol} and {MEHROTRA_SPLIT_RATIO}x the "
                f"plain float32 solve's {e_plain:.3e}")
    return len(lanes)


def phase_horizons(problem, mproblem, device, card) -> dict:
    """(c) K1 at N = 5 and N = 20 for both systems against its plain
    version, both schemes, cold and warm, at K1's tolerances (the Panda's:
    steps 5e-4, duals 0.5; the Husky+Panda's: steps 1e-3), its warm
    adaptive solve timed; then ``HORIZON_TICKS`` RTI ticks of
    ``mpc_step`` at that N (K1-K4 once a tick), 8 lanes tick by tick in
    float64 on the CPU.  Returns {system name: {N: K1 device ms}}."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        launch_config, solve_qp_ipm_k, solve_qp_ipm_plain)
    from mpcc_manipulator_tpu_torch.system import PANDA
    out, splits = {}, 0
    for base, prob, tol, duals in ((PANDA, problem, 5e-4, True),
                                   (mobile_system(), mproblem,
                                    MOBILE_IPM_TOL, False)):
        out[base.name] = {}
        for n in HORIZONS:
            sy = dataclasses.replace(base, horizon=n)
            label = f"{base.name}, N = {n}"
            cfg = launch_config(n, sy)
            print(f"K1 launch, {label}: {cfg}")
            qpk = stage_qp_batch(prob, device, sy, HORIZON_BATCH)
            for scheme in ("adaptive", "mehrotra"):
                ref = solve_qp_ipm_plain(qpk, system=sy, scheme=scheme)
                sol = solve_qp_ipm_k(qpk, system=sy, scheme=scheme)
                torch.cuda.synchronize()
                ipm_f64_gaps(f"K1 {label} {scheme} cold", qpk, {}, sol, ref,
                             sy, scheme)
                splits += compare_ipm_split(f"{label} {scheme} cold", qpk, {},
                                            sol, ref, sy, scheme, tol, duals)
                warm = dict(warm_s=torch.clamp(ref.s_rows, 0.1, 100.0),
                            warm_lam=torch.clamp(ref.lam_rows, 0.1, 100.0))
                ref = solve_qp_ipm_plain(qpk, system=sy, scheme=scheme,
                                         **warm)
                sol = solve_qp_ipm_k(qpk, system=sy, scheme=scheme, **warm)
                torch.cuda.synchronize()
                ipm_f64_gaps(f"K1 {label} {scheme} warm", qpk, warm, sol, ref,
                             sy, scheme)
                splits += compare_ipm_split(f"{label} {scheme} warm", qpk,
                                            warm, sol, ref, sy, scheme, tol,
                                            duals)
                if scheme == "adaptive":
                    t = kernel_times(lambda: solve_qp_ipm_k(
                        qpk, system=sy, **warm), "ipm_kernel<", 20)
                    out[base.name][n] = t["ms"]
                    print(f"K1 warm adaptive solve, {label}, batch "
                          f"{HORIZON_BATCH} (mean "
                          f"{sol.iters.double().mean():.3f} iterations): "
                          f"{times_text(t)}")
            x0 = perturbed_states(HORIZON_BATCH, torch.float32, device, sy)
            reset_counts()
            times, oks, states, iters, _, inputs = closed_loop(
                prob, x0, HORIZON_TICKS, SQPConfig(), record=CHECK_LANES,
                system=sy)
            launches = read_counts()
            check_ok(f"RTI, {label}", oks, states)
            want = dict(K1=HORIZON_TICKS, K2=HORIZON_TICKS, K3=HORIZON_TICKS,
                        K4=HORIZON_TICKS, K5=0, K6=HORIZON_TICKS,
                        K7=2 * HORIZON_TICKS)
            if launches != want:
                raise AssertionError(f"RTI, {label}: launches {launches}, "
                                     f"expected {want}")
            s = states[:, :, sy.s_idx]
            print(f"RTI (K1-K4), {label}, {HORIZON_BATCH} x {HORIZON_TICKS} "
                  f"ticks on {card}: all ok; median tick "
                  f"{statistics.median(times[1:]) * 1e3:.3f} ms; mean IPM "
                  f"iters {iters.float().mean():.2f}, max "
                  f"{int(iters.max())}; s {float(s[0].mean()):.5f} -> "
                  f"{float(s[-1].mean()):.5f}; launches {launches}")
            cpu_tick_by_tick(f"RTI, {label}", inputs, states, iters,
                             SQPConfig(), sy)
    print(f"K1 at N = {HORIZONS}: {splits} lanes of "
          f"{16 * HORIZON_BATCH} solves ended one Newton iteration apart "
          f"from the plain float32 solve (held to float64 at their count)")
    return out


def phase_plain_robot_data(problem, device, card) -> None:
    """(d) The plain RobotData route (``kin_backend="xla"``) on the card
    with ``mani_grad`` fd and ad, in float64, against the K4 route at the
    main path's first-tick knots of 1024 scenarios, at K4's contract; then
    ``PLAIN_KIN_TICKS`` RTI ticks with ``kin_backend="xla"``,
    ``mani_grad="fd"`` (K1-K3 once a tick, K4 never)."""
    from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.problem import build_problem
    _, _, sel64, env64 = build_problem(torch.float64, device)
    _, _, _, _, rb = main_path_inputs(problem, device, batch=BATCH)
    qs = rb.q
    k4 = (rb.ee_pos, rb.ee_rot, rb.jv, rb.jw, rb.manipul, rb.d_manipul)
    obs = torch.tensor([[3.0, 3.0, 3.0]], dtype=torch.float64,
                       device=device).expand(BATCH, 3)
    rad = torch.zeros(BATCH, dtype=torch.float64, device=device)
    for grad in ("fd", "ad"):
        plain = lambda: compute_robot_data(
            qs.double(), obs, rad, sel64, env64, mani_grad=grad,
            kin_backend="xla")
        rb64 = plain()
        ref = tuple(t.float() for t in (
            rb64.ee_pos, rb64.ee_rot, rb64.jv, rb64.jw, rb64.manipul,
            rb64.d_manipul))
        err, n_well, n_near, near = check_k4(f"K4 against the plain route "
                                             f"({grad})", k4, ref)
        print(f"plain RobotData route (mani_grad={grad}, float64) on "
              f"{card} at {tuple(qs.shape)} against K4: max|err| {err:.3e} "
              f"on {n_well} configurations; {n_near} with m < "
              f"{K4_SINGULAR_BELOW}: max|err| m {near[0]:.3e}, dm "
              f"{near[1]:.3e}; {cuda_time(plain, 5):.4f} ms a call")
    x0 = perturbed_states(BATCH, torch.float32, device)
    reset_counts()
    times, oks, states, iters, _, _ = closed_loop(
        problem, x0, PLAIN_KIN_TICKS,
        SQPConfig(kin_backend="xla", mani_grad="fd"))
    launches = read_counts()
    check_ok("RTI, plain kinematics (fd)", oks, states)
    want = dict(K1=PLAIN_KIN_TICKS, K2=PLAIN_KIN_TICKS, K3=PLAIN_KIN_TICKS,
                K4=0, K5=0, K6=PLAIN_KIN_TICKS, K7=2 * PLAIN_KIN_TICKS)
    if launches != want:
        raise AssertionError(f"RTI, plain kinematics (fd): launches "
                             f"{launches}, expected {want}")
    s = states[:, :, 7]
    print(f"RTI (K1-K3, plain kinematics, mani_grad=fd) {BATCH} x "
          f"{PLAIN_KIN_TICKS} ticks on {card}: all ok; median tick "
          f"{statistics.median(times[1:]) * 1e3:.3f} ms; s "
          f"{float(s[0].mean()):.5f} -> {float(s[-1].mean()):.5f}; "
          f"launches {launches}")


def phase_scan(problem, device, card) -> dict:
    """(e) ``sim.closed_loop_scan`` at batch 1024 (the counts set to 0 just
    before and read just after: K1-K4 once a tick), its states and inputs
    equal, bit for bit, to the same ticks driven through ``mpc_step`` and
    the plant step."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.sim import closed_loop_scan
    track, params, sel_nn, env_nn = problem
    x0 = perturbed_states(BATCH, torch.float32, device)
    obs = torch.tensor([[3.0, 3.0, 3.0]], device=device).expand(BATCH, 3)
    rad = torch.zeros(BATCH, device=device)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, us, _, oks, fin = closed_loop_scan(
        track, params, sel_nn, env_nn, x0, obs, rad, n_steps=SCAN_TICKS,
        ts=TS, cfg=SQPConfig())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    want = dict(K1=SCAN_TICKS, K2=SCAN_TICKS, K3=SCAN_TICKS, K4=SCAN_TICKS,
                K5=0, K6=SCAN_TICKS, K7=2 * SCAN_TICKS)
    if launches != want or not bool(oks.all()):
        raise AssertionError(f"closed_loop_scan: launches {launches} "
                             f"(expected {want}), all ok {bool(oks.all())}")
    carry = init_carry(BATCH, torch.float32, device)
    x, u = x0, torch.zeros(BATCH, 8, device=device)
    ref_x, ref_u = [], []
    for _ in range(SCAN_TICKS):
        carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x, u,
                              obs, rad, ts=TS, cfg=SQPConfig())
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        ref_x.append(x)
        ref_u.append(u)
    same = (torch.equal(xs, torch.stack(ref_x, 1))
            and torch.equal(us, torch.stack(ref_u, 1)))
    if not same or bool(fin.any()):
        raise AssertionError(
            f"closed_loop_scan: states equal to mpc_step's {same}, lanes "
            f"finished {int(fin[:, -1].sum())}")
    print(f"closed_loop_scan (RTI, K1-K4) {BATCH} x {SCAN_TICKS} ticks on "
          f"{card}: all ok, states and inputs bit-identical to mpc_step's "
          f"ticks; {SCAN_TICKS / secs:.2f} ticks/s, "
          f"{BATCH * SCAN_TICKS / secs:.1f} solves/s; launches {launches}")
    return dict(ticks_per_s=SCAN_TICKS / secs, launches=launches)


# ------------------------------------------------------------ runtime layer


def phase_native() -> dict:
    """The native runtime library built from the port's own source into
    ``build/native/`` (no fallback: ``native_available()`` must hold)."""
    from mpcc_manipulator_tpu_torch.runtime import native
    t0 = time.perf_counter()
    path = native.build()
    if not native.native_available():
        raise AssertionError("runtime: the native library did not load")
    print(f"native runtime library {os.path.relpath(path)} (built or found "
          f"in {time.perf_counter() - t0:.1f} s)")
    return dict(path=path)


def phase_checkpoint(problem, device, card) -> dict:
    """A resume on the card at batch 1024 with K1-K4 (``SQPConfig()``): 6
    ticks, save, 3 ticks, against restore + 3 ticks, bit for bit in every
    leaf of (MPCCarry, x, u) (the counts set to 0 just before and read just
    after: K1-K4 12 times each).  Times the save and the restore."""
    import tempfile
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.runtime import checkpoint as ckpt
    track, params, sel_nn, env_nn = problem
    obs = torch.tensor([[3.0, 3.0, 3.0]], device=device).expand(BATCH, 3)
    rad = torch.zeros(BATCH, device=device)

    def tick(state):
        carry, x, u = state
        carry, out = mpc_step(track, params, sel_nn, env_nn, carry, x, u,
                              obs, rad, ts=TS, cfg=SQPConfig())
        return carry, sim_time_step(out.x0_updated, out.u0, TS), out.u0

    template = lambda: (init_carry(BATCH, torch.float32, device),
                        perturbed_states(BATCH, torch.float32, device),
                        torch.zeros(BATCH, 8, device=device))
    reset_counts()
    st = template()
    for _ in range(CKPT_TICKS):
        st = tick(st)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"ckpt_{CKPT_TICKS}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_state(path, st, step=CKPT_TICKS)
        t1 = time.perf_counter()
        restored, step = ckpt.restore_state(path, template())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    for _ in range(CKPT_RESUME):
        st = tick(st)
        restored = tick(restored)
    torch.cuda.synchronize()
    launches = read_counts()
    from mpcc_manipulator_tpu_torch.runtime.checkpoint import \
        _flatten_with_names
    a, b = _flatten_with_names(st), _flatten_with_names(restored)
    same = [n for (n, x), (_, y) in zip(a, b)
            if x.device == y.device and torch.equal(x, y)]
    n_ticks = CKPT_TICKS + 2 * CKPT_RESUME
    want = dict(K1=n_ticks, K2=n_ticks, K3=n_ticks, K4=n_ticks, K5=0,
                K6=n_ticks, K7=2 * n_ticks)
    if step != CKPT_TICKS or len(same) != len(a) or launches != want:
        raise AssertionError(
            f"checkpoint resume: step {step}, bit-identical leaves {same} of "
            f"{[n for n, _ in a]}, launches {launches} (expected {want})")
    ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
    print(f"checkpoint resume (RTI, K1-K4) {BATCH} lanes on {card}: "
          f"{CKPT_TICKS} ticks, save, {CKPT_RESUME} ticks against restore + "
          f"{CKPT_RESUME} ticks: all {len(a)} leaves bit-identical; save "
          f"{ms[0]:.3f} ms, restore {ms[1]:.3f} ms ({size} B); launches "
          f"{launches}")
    return dict(save_ms=ms[0], restore_ms=ms[1], bytes=size)


def phase_bridge(card, device) -> dict:
    """``IsaacBridge`` on the card (``MPCC()``, JAX's default
    configuration) over ``LoopbackSimTransport``: 12 ticks, every tick ok,
    s rising, and the JointState contract of every command (the four
    wheel names zero-padded first, then the seven arm joints, velocities
    the MPC's u0)."""
    from mpcc_manipulator_tpu_torch.runtime.sim_bridge import (
        IsaacBridge, LoopbackSimTransport, PANDA_JOINT_NAMES,
        WHEEL_JOINT_NAMES)
    transport = LoopbackSimTransport(home()[:7])
    bridge = IsaacBridge(transport, device=device)
    transport.start()
    for _ in range(BRIDGE_TICKS):
        transport.spin_once()
    lg, cmds = bridge.log, transport.published.get("/joint_command", [])
    ok = (len(lg["s"]) == BRIDGE_TICKS and all(lg["ok"])
          and len(cmds) == BRIDGE_TICKS and lg["s"][-1] > lg["s"][2] > 0.0
          and "/mpcc/splined_path" in transport.published
          and len(transport.published.get("/mpcc/local_path", []))
          == BRIDGE_TICKS)
    for m in cmds:
        ok = ok and (m["name"] == WHEEL_JOINT_NAMES + PANDA_JOINT_NAMES
                     and m["position"][:4] == [0.0] * 4
                     and m["velocity"][:4] == [0.0] * 4
                     and len(m["position"]) == len(m["velocity"]) == 11)
    ok = ok and np.allclose(cmds[-1]["velocity"][4:], bridge._input[:7])
    if not ok:
        raise AssertionError(f"sim_bridge: ok {lg['ok']}, s {lg['s']}, "
                             f"{len(cmds)} commands")
    st = np.asarray(lg["solve_time"][1:]) * 1e3
    print(f"IsaacBridge over LoopbackSimTransport on {card}: "
          f"{BRIDGE_TICKS} ticks all ok, s {lg['s'][0]:.5f} -> "
          f"{lg['s'][-1]:.5f}, every /joint_command in the JointState "
          f"contract; solve median {np.median(st):.3f} ms")
    return dict(median_ms=float(np.median(st)))


def demo_tick_ms(times_s) -> dict:
    ms = np.asarray(times_s[1:]) * 1e3
    return dict(ticks=len(times_s), first_ms=float(times_s[0]) * 1e3,
                median_ms=float(np.median(ms)),
                p99_ms=float(np.percentile(ms, 99)))


def phase_demos(card, device) -> dict:
    """``main_demo.main()`` and ``main_obstacle_demo.main()`` in-process on
    the card in float32, ``DEMO_TICKS`` / ``OBSTACLE_DEMO_TICKS`` ticks
    into a temporary directory: ``splined_path.txt``
    one line a spline knot, 7 columns (position, quaternion), finite;
    ``debug.txt`` one line a tick, 22 columns, finite, s rising; the
    ``.mat`` the reference's ten channels, one row a tick.  The tick times
    come from the files (debug.txt's last column, the .mat's solve_time)."""
    import contextlib
    import io
    import tempfile
    from scipy.io import loadmat
    from mpcc_manipulator_tpu_torch.runtime import main_demo
    from mpcc_manipulator_tpu_torch.runtime import main_obstacle_demo
    out = {}
    with tempfile.TemporaryDirectory() as d:
        ticks = DEMO_TICKS
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            main_demo.main(["--n_sim", str(ticks), "--float32", "--device",
                            str(device), "--out_dir", d])
        secs = time.perf_counter() - t0
        spl = np.loadtxt(os.path.join(d, "splined_path.txt"))
        dbg = np.loadtxt(os.path.join(d, "debug.txt"), ndmin=2)
        if (spl.ndim != 2 or spl.shape[1] != 7 or spl.shape[0] < 50
                or dbg.shape != (ticks, 22)
                or not np.isfinite(spl).all()
                or not np.isfinite(dbg).all()
                or not (np.diff(dbg[:, 19]) > 0).all()):
            raise AssertionError(
                f"main_demo: splined_path {spl.shape}, debug "
                f"{dbg.shape}; output:\n{log.getvalue()}")
        t = demo_tick_ms(dbg[:, 21])
        out["main_demo_float32"] = t
        print(f"main_demo --float32 --device {device}, {ticks} ticks on "
              f"{card} ({secs:.1f} s): splined_path.txt {spl.shape[0]} x 7, "
              f"debug.txt {dbg.shape[0]} x 22, finite, s rising to "
              f"{dbg[-1, 19]:.5f}; tick median {t['median_ms']:.3f} ms, p99 "
              f"{t['p99_ms']:.3f} ms (first {t['first_ms']:.1f})")
        mat = os.path.join(d, "obstacle.mat")
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            main_obstacle_demo.main(["--n_sim", str(OBSTACLE_DEMO_TICKS),
                                     "--float32", "--device", str(device),
                                     "--mat", mat])
        secs = time.perf_counter() - t0
        m = loadmat(mat)
        keys = sorted(k for k in m if not k.startswith("__"))
        want = sorted(["ee_speed", "mani", "sel_min_dist", "env_min_dist",
                       "contour_error", "s", "obs_z", "solve_time", "q",
                       "qdot"])
        rows = {k: m[k].shape[-1] if m[k].shape[0] == 1 else m[k].shape[0]
                for k in keys}
        if (keys != want or set(rows.values()) != {OBSTACLE_DEMO_TICKS}
                or m["q"].shape != (OBSTACLE_DEMO_TICKS, 7)
                or not all(np.isfinite(m[k]).all() for k in keys)):
            raise AssertionError(f"main_obstacle_demo: keys {keys}, rows "
                                 f"{rows}; output:\n{log.getvalue()}")
        t = demo_tick_ms(m["solve_time"].reshape(-1))
        out["main_obstacle_demo_float32"] = t
        print(f"main_obstacle_demo --float32 --device {device}, "
              f"{OBSTACLE_DEMO_TICKS} ticks on {card} ({secs:.1f} s): .mat "
              f"with the ten channels x {OBSTACLE_DEMO_TICKS} rows, finite; "
              f"min env distance {float(m['env_min_dist'].min()):.2f} cm; "
              f"tick median {t['median_ms']:.3f} ms, p99 {t['p99_ms']:.3f} ms")
    return out


def phase_gates(card, device) -> dict:
    """The JAX package's closed-loop gates on the card in float32 on 8
    lanes (the exact home state and 7 lanes at 1e-3 N(0, 1) on the
    joints), K1-K4, through `mpcc_manipulator_tpu_torch/gates.py`'s
    runners with the JAX tests' thresholds: the repo's track to the end
    point (converged, 3,000-tick budget), the static obstacle constrained
    (margin, CBF contract), RTI against the converged mode (60 ticks) and
    the config ladder (12 ticks a rung); each gate's figures printed as
    JSON."""
    from mpcc_manipulator_tpu_torch import gates
    out = {}
    for name, kwargs in CARD_GATES:
        reset_counts()
        t0 = time.perf_counter()
        res = gates.GATES[name](dtype=torch.float32, device=device,
                                lanes=gates.LANES, **kwargs)
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = read_counts()
        if res["launches"]["K1"] == 0 or res["launches"]["K4"] == 0:
            raise AssertionError(f"gate {name}: K1/K4 never launched")
        print(f"gate {name} on {card}: passed; {json.dumps(res)}")
        out[name] = res
    return out


# ------------------------------------------------------------ sharding


def sharded_inputs(x0: torch.Tensor, system) -> tuple:
    """(carry, x0, u0, obs_pos, obs_radius) for the rows of ``x0``: a cold
    carry, zero inputs, the obstacle far away."""
    from mpcc_manipulator_tpu_torch.parallel import sharding as shd
    b, dt, dev = x0.shape[0], x0.dtype, x0.device
    return (shd.batch_init_carry(b, dt, system, dev), x0,
            torch.zeros(b, system.nu, dtype=dt, device=dev),
            torch.tensor([[3.0, 3.0, 3.0]], dtype=dt, device=dev).expand(b, 3),
            torch.zeros(b, dtype=dt, device=dev))


def tick_loop(step, problem, scen, ticks: int) -> tuple:
    """``ticks`` closed-loop ticks of ``step(track, params, sel_nn, env_nn,
    carry, x, u, obs, rad)`` and the plant step from ``scen``: each tick's
    output, the plant states (ticks, B, nx) and each tick's host seconds."""
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    carry, x, u, obs, rad = scen
    sync = torch.cuda.synchronize if x.device.type == "cuda" else lambda: None
    outs, states, times = [], [], []
    for _ in range(ticks):
        sync()
        t0 = time.perf_counter()
        carry, out = step(*problem, carry, x, u, obs, rad)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        sync()
        times.append(time.perf_counter() - t0)
        outs.append(out)
        states.append(x)
    return outs, torch.stack(states), times


def gloo_rank(rank: int, world: int, init_file: str, device: str,
              batch: int, results) -> None:
    """One spawned rank of the two-process run: joins the gloo group, runs
    its slice of the Panda's ``batch`` lanes (RTI, ``SHARDED_TICKS``) on
    ``device`` (the card), reduces the fleet diagnostics over gloo there,
    and sends its rows (or its traceback) back."""
    import traceback
    try:
        import torch.distributed as dist
        from mpcc_manipulator_tpu_torch.params import SQPConfig
        from mpcc_manipulator_tpu_torch.parallel import sharding as shd
        from mpcc_manipulator_tpu_torch.problem import build_problem
        from mpcc_manipulator_tpu_torch.system import PANDA
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device(device)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            mesh = shd.make_mesh(devices=[device] * world)
            problem = shd.replicate(build_problem(torch.float32, device),
                                    mesh)
            scen = shd.shard_batch(sharded_inputs(perturbed_states(
                batch, torch.float32, device), PANDA), mesh)
            step = shd.make_sharded_step(mesh, ts=TS, cfg=SQPConfig())
            outs, states, times = tick_loop(step, problem, scen,
                                            SHARDED_TICKS)
            diag = shd.fleet_diagnostics(outs[-1].ok, outs[-1].sqp_iters,
                                         mesh)
            results.put((rank, dict(
                u=torch.stack([o.u0 for o in outs]).cpu().numpy(),
                x=states.cpu().numpy(),
                ok=torch.stack([o.ok for o in outs]).cpu().numpy(),
                diag={k: float(v) for k, v in diag.items()},
                diag_device=str(diag["success_rate"].device),
                times=times)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def phase_sharded(problem, mproblem, device, card) -> dict:
    """`parallel/sharding.py` on the card.  (a) NCCL at world size 1:
    ``SHARDED_TICKS`` RTI ticks of the sharded step (the counts set to 0
    just before and read just after: K1-K4 once a tick) bit-identical to
    ``mpc_step`` on the same inputs, for the Panda at BATCH and the
    Husky+Panda at MOBILE_BATCHES[0]; ``fleet_diagnostics`` through NCCL
    equal to the local means; both paths' median tick.  (b) The Panda's
    BATCH lanes split over GLOO_RANKS spawned processes on the one card
    against the unsharded ticks of (a): every lane ok every tick and inside
    the RTI envelope, the bit-identical lanes counted, the fleet
    diagnostics over gloo exact.  A rank that fails fails the phase."""
    import multiprocessing
    import tempfile
    import torch.distributed as dist
    from mpcc_manipulator_tpu_torch.mpc import mpc_step
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.parallel import sharding as shd
    from mpcc_manipulator_tpu_torch.system import PANDA
    cfg = SQPConfig()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/nccl",
                                rank=0, world_size=1)
        try:
            mesh = shd.make_mesh()
            if (mesh.world_size, mesh.device) != (1, device):
                raise AssertionError(f"make_mesh over NCCL: {mesh}")
            for label, system, prob, batch in (
                    ("Panda", PANDA, problem, BATCH),
                    ("Husky+Panda", mobile_system(), mproblem,
                     MOBILE_BATCHES[0])):
                scen = sharded_inputs(perturbed_states(
                    batch, torch.float32, device, system), system)
                step = shd.make_sharded_step(mesh, ts=TS, cfg=cfg,
                                             system=system)
                reset_counts()
                sh_outs, sh_x, sh_t = tick_loop(
                    step, shd.replicate(prob, mesh),
                    shd.shard_batch(scen, mesh), SHARDED_TICKS)
                launches = read_counts()
                ref_outs, ref_x, ref_t = tick_loop(
                    lambda *a: mpc_step(*a, ts=TS, cfg=cfg, system=system),
                    prob, scen, SHARDED_TICKS)
                want = dict(K1=SHARDED_TICKS, K2=SHARDED_TICKS,
                            K3=SHARDED_TICKS, K4=SHARDED_TICKS, K5=0,
                            K6=SHARDED_TICKS, K7=2 * SHARDED_TICKS)
                same = torch.equal(sh_x, ref_x) and all(
                    torch.equal(getattr(a, f.name), getattr(b, f.name))
                    for a, b in zip(sh_outs, ref_outs)
                    for f in dataclasses.fields(a))
                ok = torch.stack([o.ok for o in sh_outs])
                if launches != want or not same or not bool(ok.all()):
                    raise AssertionError(
                        f"sharded {label}: launches {launches} (expected "
                        f"{want}), bit-identical to mpc_step {same}, all ok "
                        f"{bool(ok.all())}")
                last = sh_outs[-1]
                diag = shd.fleet_diagnostics(last.ok, last.sqp_iters, mesh)
                local = shd.fleet_diagnostics(last.ok, last.sqp_iters)
                if any(not torch.equal(diag[k], local[k]) for k in diag):
                    raise AssertionError(f"sharded {label}: NCCL fleet "
                                         f"diagnostics {diag} != {local}")
                med_sh = statistics.median(sh_t[1:])
                med_ref = statistics.median(ref_t[1:])
                print(f"sharded step (NCCL, world size 1) {label} {batch} x "
                      f"{SHARDED_TICKS} RTI ticks on {card}: bit-identical "
                      f"to mpc_step, all ok; median tick {med_sh * 1e3:.3f} "
                      f"ms ({batch / med_sh:.1f} solves/s) against mpc_step "
                      f"{med_ref * 1e3:.3f} ms ({batch / med_ref:.1f} "
                      f"solves/s); fleet diagnostics "
                      f"{ {k: float(v) for k, v in diag.items()} }; "
                      f"launches {launches}")
                out[label] = dict(tick_ms=med_sh * 1e3,
                                  mpc_step_ms=med_ref * 1e3,
                                  launches=launches)
                if system is PANDA:
                    ref_u = torch.stack([o.u0 for o in ref_outs]).cpu()
                    ref_states = ref_x.cpu()
                    ref_diag = {k: float(v) for k, v in local.items()}
        finally:
            dist.destroy_process_group()

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=gloo_rank,
                             args=(r, GLOO_RANKS, f"{d}/gloo", str(device),
                                   BATCH, results))
                 for r in range(GLOO_RANKS)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                rank, res = results.get(timeout=GLOO_TIMEOUT)
                if isinstance(res, str):
                    raise AssertionError(f"gloo rank {rank} failed:\n{res}")
                got[rank] = res
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if [p.exitcode for p in procs] != [0] * GLOO_RANKS:
        raise AssertionError(f"gloo ranks exited "
                             f"{[p.exitcode for p in procs]}")
    u = np.concatenate([got[r]["u"] for r in range(GLOO_RANKS)], axis=1)
    x = np.concatenate([got[r]["x"] for r in range(GLOO_RANKS)], axis=1)
    ok = np.concatenate([got[r]["ok"] for r in range(GLOO_RANKS)], axis=1)
    du = np.abs(u - ref_u.numpy())
    dx = np.abs(x - ref_states.numpy())
    gaps = {"u": float(du.max()), "q": float(dx[..., :7].max()),
            "s": float(dx[..., 7].max()), "vs": float(dx[..., 8].max())}
    identical = int(((du.max(axis=(0, 2)) == 0)
                     & (dx.max(axis=(0, 2)) == 0)).sum())
    diags = [got[r]["diag"] for r in range(GLOO_RANKS)]
    bad = (not ok.all()
           or any(gaps[k] >= ENVELOPE[k] for k in ("q", "s", "vs"))
           or any(dg != ref_diag for dg in diags)
           or any(got[r]["diag_device"] != str(device)
                  for r in range(GLOO_RANKS)))
    if bad:
        raise AssertionError(
            f"sharded over {GLOO_RANKS} gloo ranks: all ok {bool(ok.all())}, "
            f"gaps {gaps} (envelope {ENVELOPE}), fleet diagnostics {diags} "
            f"against {ref_diag} on {[g['diag_device'] for g in got.values()]}")
    rank_ms = [statistics.median(got[r]["times"][1:]) * 1e3
               for r in range(GLOO_RANKS)]
    print(f"sharded step over {GLOO_RANKS} gloo ranks on one card "
          f"({card}), Panda {BATCH} lanes x {SHARDED_TICKS} RTI ticks, "
          f"{BATCH // GLOO_RANKS} a rank: all ok; {identical} of {BATCH} "
          f"lanes bit-identical to the unsharded ticks; max |du| "
          f"{gaps['u']:.3e}, |dq| {gaps['q']:.3e}, |ds| {gaps['s']:.3e}, "
          f"|dvs| {gaps['vs']:.3e} (envelope {ENVELOPE}); fleet "
          f"diagnostics over gloo on {got[0]['diag_device']} {diags[0]} "
          f"equal to the unsharded means; median tick per rank "
          f"{[round(t, 3) for t in rank_ms]} ms; "
          f"{time.perf_counter() - t0:.1f} s with the spawns")
    out["gloo"] = dict(identical_lanes=identical, gaps=gaps,
                       rank_tick_ms=rank_ms)
    return out


# the routes phase: RTI ticks per route and system, the fleet-mode ticks
# (the converged mode at max_iter), the bf16 ticks, and the first tick's
# QPs held across the three IPMs at K1's contract
ROUTE_TICKS = 5
ROUTE_BATCHES = {"panda": BATCH, "husky_panda": MOBILE_BATCHES[0]}
FLEET = dict(rti=False, max_iter=5)
FLEET_TICKS = 3
BF16_TICKS = 10
BF16_DQ = 2e-4        # JAX tests/test_nn_bf16.py (one lane)
ROUTE_IPM_TOL = 5e-4  # tests/test_qp_ipm_pallas.py:77-137
# the loops whose host reads fleet mode removes
LOOP_FILES = ("solver/sqp.py", "solver/qp_ipm.py")


def route_cfgs() -> dict:
    """The Riccati routes as a user selects them: the bench configuration
    (K1-K4), and the packed and structured solvers (the plain assembly
    and IPM, as JAX requires; K4 for the kinematics)."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    plain = dict(qp_assembly="xla", kin_backend="pallas",
                 mani_grad="analytic", ipm_warm_start=True)
    return {"riccati_pallas": SQPConfig(),
            "riccati_struct": SQPConfig(qp_solver="riccati_struct", **plain),
            "riccati": SQPConfig(qp_solver="riccati", **plain)}


def first_tick_solves(prob, device, system, batch) -> dict:
    """The first tick's QPs (the cold-start horizon at the perturbed
    states, current u zero) solved cold by each route's IPM: the packed
    solve, the structured one and K1 (adaptive)."""
    from mpcc_manipulator_tpu_torch.ocp import qp_stages
    from mpcc_manipulator_tpu_torch.solver import qp_ipm
    from mpcc_manipulator_tpu_torch.solver.qp_ipm_kernel import (
        solve_qp_ipm_k)
    track, params = prob[:2]
    z, _, _, _, rb = main_path_inputs(prob, device, system, batch)
    u0 = torch.zeros(batch, system.nu, dtype=torch.float32, device=device)
    args = (track, z, rb, params, u0, TS)
    packed = qp_ipm.solve_qp_ipm(qp_stages.build_qp_stages(
        *args, system=system))
    struct = qp_ipm.solve_qp_ipm_s(qp_stages.build_qp_stages_s(
        *args, system=system))
    kernel = solve_qp_ipm_k(qp_stages.build_qp_stages_k(
        *args, system=system), system=system)
    torch.cuda.synchronize()
    return {"riccati": packed, "riccati_struct": struct,
            "riccati_pallas": kernel}


def route_ticks(prob, x0, cfg, ticks, system) -> tuple:
    """``ticks`` RTI / converged ticks of ``cfg`` with the counts set to 0
    just before and read just after: (host times, ok, states, launches,
    outputs)."""
    reset_counts()
    times, oks, states, iters, sqp_iters, _ = closed_loop(
        prob, x0, ticks, cfg, system=system)
    return times, oks, states, read_counts(), (iters, sqp_iters)


def sync_sites(fn) -> list:
    """The device-to-host syncs ``fn()`` makes
    (``torch.cuda.set_sync_debug_mode``'s warnings), each as ``file:line``
    of the innermost line of the package on the stack that asked for it."""
    import traceback
    import warnings
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mpcc_manipulator_tpu_torch")
    sites = []

    def record(message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(pkg)]
        sites.append(f"{os.path.relpath(frames[-1].filename, pkg)}:"
                     f"{frames[-1].lineno}" if frames else
                     f"outside the package ({os.path.basename(filename)}:"
                     f"{lineno})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def nn_half_device_ms(rb_inputs, mm_dtype, reps: int = 10) -> dict:
    """The NN half of RobotData on ``rb_inputs`` with its GEMMs in
    ``mm_dtype``: device ms a call of every kernel it launches, and of its
    GEMMs alone (kernels named gemm / xmma / cutlass), from
    ``torch.profiler``; and the host-clock ms of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mpcc_manipulator_tpu_torch.ocp.robot_data import _nn_half
    call = lambda: _nn_half(*rb_inputs, nn_mm_dtype=mm_dtype)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = lambda e: getattr(e, "device_time_total", None) or e.cuda_time_total
    gemm = [e for e in kernels
            if any(k in e.name.lower() for k in ("gemm", "xmma", "cutlass"))]
    names = sorted({e.name[:60] for e in gemm})
    return {"all_ms": sum(us(e) for e in kernels) / reps / 1e3,
            "gemm_ms": sum(us(e) for e in gemm) / reps / 1e3,
            "gemm_kernels": names, "call_ms": cuda_time(call, reps)}


def phase_routes(problem, mproblem, device, card) -> dict:
    """Every SQPConfig route beside the bench's on the card (docstring,
    item 22)."""
    from mpcc_manipulator_tpu_torch.ocp import qp_data
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.solver import sqp
    from mpcc_manipulator_tpu_torch.system import PANDA
    out = {}
    cfgs = route_cfgs()
    no_kernel = dict(K1=0, K2=0, K3=0, K5=0, K6=ROUTE_TICKS,
                     K7=2 * ROUTE_TICKS)
    for name, system, prob in (("panda", PANDA, problem),
                               ("husky_panda", mobile_system(), mproblem)):
        batch = ROUTE_BATCHES[name]
        sols = first_tick_solves(prob, device, system, batch)
        ref = sols["riccati_struct"]
        gaps = {}
        for route in ("riccati", "riccati_pallas"):
            sol, label = sols[route], f"routes, {name} first tick, {route}"
            d_it = int((sol.iters - ref.iters).abs().max())
            if d_it > 1:
                raise AssertionError(f"{label}: Newton iterations differ "
                                     f"from riccati_struct's by {d_it}")
            gaps[route] = max(
                check_close(f"{label} du", sol.du, ref.du, ROUTE_IPM_TOL),
                check_close(f"{label} dx", sol.dx_tilde, ref.dx_tilde,
                            ROUTE_IPM_TOL))
        x0 = perturbed_states(batch, torch.float32, device, system)
        med, final = {}, {}
        for route, cfg in cfgs.items():
            times, oks, states, launches, _ = route_ticks(
                prob, x0, cfg, ROUTE_TICKS, system)
            final[route] = states
            check_ok(f"route {route} {name}", oks, states)
            want = (dict(K1=ROUTE_TICKS, K2=ROUTE_TICKS, K3=ROUTE_TICKS,
                         K4=ROUTE_TICKS, K5=0, K6=ROUTE_TICKS,
                         K7=2 * ROUTE_TICKS)
                    if route == "riccati_pallas"
                    else dict(no_kernel, K4=ROUTE_TICKS))
            if launches != want:
                raise AssertionError(f"route {route} {name}: launches "
                                     f"{launches}, expected {want}")
            med[route] = statistics.median(times[1:]) * 1e3
        q = slice(system.base_dof, system.dof)
        route_gap = {r: float((final[r][..., q] - final["riccati_struct"]
                               [..., q]).abs().max())
                     for r in ("riccati_pallas", "riccati")}
        print(f"routes, {name} {batch} x {ROUTE_TICKS} RTI ticks on {card}: "
              f"all ok; median tick ms "
              + ", ".join(f"{r} {v:.3f}" for r, v in med.items())
              + f"; first tick's QPs against riccati_struct: max|d step| "
              f"packed {gaps['riccati']:.3e}, K1 {gaps['riccati_pallas']:.3e}"
              f"; Newton iterations mean packed "
              f"{sols['riccati'].iters.float().mean():.2f}, struct "
              f"{ref.iters.float().mean():.2f}, K1 "
              f"{sols['riccati_pallas'].iters.float().mean():.2f}; the "
              f"float32 states after {ROUTE_TICKS} ticks, max |d q| "
              f"against riccati_struct: K1-K4 {route_gap['riccati_pallas']:.3e},"
              f" packed {route_gap['riccati']:.3e}")
        out[name] = dict(tick_ms=med, step_gap=gaps, state_gap=route_gap)

    # fleet mode on the bench configuration, the converged mode
    x0 = perturbed_states(BATCH, torch.float32, device)
    runs = {}
    for fleet in (False, True):
        cfg = SQPConfig(fleet_mode=fleet, **FLEET)
        runs[fleet] = route_ticks(problem, x0, cfg, FLEET_TICKS, PANDA)
    (t0_, ok0, st0, l0, it0), (t1_, ok1, st1, l1, it1) = runs[False], \
        runs[True]
    check_ok("fleet mode", ok1, st1)
    same = (torch.equal(st0, st1) and torch.equal(ok0, ok1)
            and all(torch.equal(a, b) for a, b in zip(it0, it1)))
    per = FLEET["max_iter"] * FLEET_TICKS
    if not same or l1 != dict(K1=per, K2=per, K3=per, K4=FLEET_TICKS, K5=0,
                              K6=FLEET_TICKS, K7=2 * FLEET_TICKS):
        raise AssertionError(f"fleet mode: bit-identical {same}, launches "
                             f"{l1} (early exit {l0})")
    # the syncs of one solve_ocp (the first tick's inputs), both modes, on
    # the bench route and on the packed route (the plain IPM)
    z, _, _, _, rb = main_path_inputs(problem, device, batch=BATCH)
    u0 = torch.zeros(BATCH, 8, dtype=torch.float32, device=device)
    track, params = problem[:2]
    syncs = {}
    for route in ("riccati_pallas", "riccati"):
        for fleet in (False, True):
            cfg = dataclasses.replace(cfgs[route], fleet_mode=fleet,
                                      **FLEET)
            solve = lambda: sqp.solve_ocp(track, rb, params, cfg, z, u0, TS)
            solve()
            syncs[(route, fleet)] = sync_sites(solve)
    loops = {k: [s for s in v if s.startswith(LOOP_FILES)]
             for k, v in syncs.items()}
    if any(loops[(r, True)] for r in ("riccati_pallas", "riccati")):
        raise AssertionError(f"fleet mode: host syncs from the SQP / IPM "
                             f"loops: {loops}")
    count = lambda sites: {s: sites.count(s) for s in sorted(set(sites))}
    print(f"fleet mode (bench configuration, converged max_iter="
          f"{FLEET['max_iter']}) {BATCH} x {FLEET_TICKS} ticks on {card}: "
          f"bit-identical to the early exit; launches {l1} (early exit "
          f"{l0}); median tick {statistics.median(t1_[1:]) * 1e3:.3f} ms "
          f"(early exit {statistics.median(t0_[1:]) * 1e3:.3f} ms)")
    for (route, fleet), sites in syncs.items():
        print(f"  syncs of one solve_ocp, {route}, fleet_mode={fleet}: "
              f"{len(sites)} ({len(loops[(route, fleet)])} from the SQP / "
              f"IPM loops) {count(sites)}")
    out["fleet"] = dict(launches=l1, early_launches=l0,
                        syncs={f"{r} fleet={f}": len(v)
                               for (r, f), v in syncs.items()})

    # the bf16 NN GEMMs on the bench configuration: JAX's bound where every
    # Newton count is the float32 run's; where the bf16 perturbation moves
    # the IPM's stop test to another iteration, the RTI envelope (JAX
    # drifts there alike: tests/test_torch_nn_bf16.py)
    _, oks16, st16, l16, (it16, _) = route_ticks(
        problem, x0, SQPConfig(nn_bf16=True), BF16_TICKS, PANDA)
    _, _, st32, _, (it32, _) = route_ticks(problem, x0, SQPConfig(),
                                           BF16_TICKS, PANDA)
    check_ok("nn_bf16", oks16, st16)
    dq_lane = (st16[..., :7] - st32[..., :7]).abs().amax(dim=(0, 2))
    split = (it16 != it32).any(dim=0)
    dq = float(dq_lane[~split].max())
    dq_split = float(dq_lane[split].max()) if bool(split.any()) else 0.0
    if (dq >= BF16_DQ or dq_split >= ENVELOPE["q"]
            or l16 != dict(K1=BF16_TICKS, K2=BF16_TICKS, K3=BF16_TICKS,
                           K4=BF16_TICKS, K5=0, K6=BF16_TICKS, K7=0)):
        raise AssertionError(f"nn_bf16: |dq| {dq:.3e} (bound {BF16_DQ}), "
                             f"on lanes with a moved Newton count "
                             f"{dq_split:.3e} (envelope {ENVELOPE['q']}), "
                             f"launches {l16}")
    xs, _ = qp_data.split_z(z, PANDA)
    obs = torch.tensor([[3.0, 3.0, 3.0]], device=device).expand(BATCH, 3)
    nn_in = (xs[..., :7].contiguous(), obs, problem[2], problem[3], PANDA)
    nn = {k: nn_half_device_ms(nn_in, k) for k in (None, "bfloat16")}
    # the bf16 GEMM's call (`models/collision_nn.py::_mm`): its product is
    # float32 before any cast
    bf = torch.ones(4, 4, dtype=torch.bfloat16, device=device)
    mm_dtype = torch.mm(bf, bf, out_dtype=torch.float32).dtype
    print(f"nn_bf16 (bench configuration) {BATCH} x {BF16_TICKS} RTI ticks "
          f"on {card}: all ok; max |dq| against the float32 GEMMs' run "
          f"{dq:.3e} (bound {BF16_DQ}) on {int((~split).sum())} lanes, "
          f"{dq_split:.3e} on the {int(split.sum())} whose Newton counts "
          f"moved (envelope {ENVELOPE['q']}; median |dq| "
          f"{float(dq_lane.median()):.3e}); launches {l16}; the NN half at "
          f"({BATCH}, {KNOTS}) knots, device ms a call float32 "
          f"{nn[None]['all_ms']:.4f} (GEMMs {nn[None]['gemm_ms']:.4f}, "
          f"{nn[None]['gemm_kernels']}), bf16 {nn['bfloat16']['all_ms']:.4f} "
          f"(GEMMs {nn['bfloat16']['gemm_ms']:.4f}, "
          f"{nn['bfloat16']['gemm_kernels']}); CUDA-event ms a call "
          f"{nn[None]['call_ms']:.4f} / {nn['bfloat16']['call_ms']:.4f}; "
          f"torch.mm(bf16, bf16, out_dtype=torch.float32) gives {mm_dtype}")
    if mm_dtype != torch.float32:
        raise AssertionError(f"nn_bf16: the GEMM's product is {mm_dtype}")
    out["nn_bf16"] = dict(dq=dq, dq_split=dq_split,
                          split_lanes=int(split.sum()), nn_ms=nn)
    return out


def phase_surface(card) -> dict:
    """The package root's ``MPCC``, the 10-DoF manipulability gradient,
    the unencoded Jacobian and the bf16 NN route on the card, each against
    the same call on the CPU (docstring, item 23)."""
    import mpcc_manipulator_tpu_torch as M
    from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
    from mpcc_manipulator_tpu_torch.models import kinematics_mobile as kmob
    from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
    from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
    from mpcc_manipulator_tpu_torch.system import PANDA
    f64, f32 = torch.float64, torch.float32
    rng = np.random.default_rng(SEED)
    out = {}

    # one tick of the package root's MPCC, JAX's default configuration
    x, u = home(), np.zeros(M.NU)
    states = []
    for device in ("cuda", "cpu"):
        mpc = M.MPCC() if device == "cuda" else M.MPCC(device="cpu")
        mpc.setTrack(x)
        reset_counts()
        ok, x_upd, u_out, _, ct = mpc.runMPC(x, u)
        if device == "cuda":
            launches, tick_ms = read_counts(), ct["total"] * 1e3
        if not ok or not np.isfinite(u_out).all():
            raise AssertionError(f"surface: M.MPCC() tick on {device} not "
                                 f"ok ({ok}) or not finite")
        states.append(sim_time_step(torch.tensor(x_upd, dtype=f64)[None],
                                    torch.tensor(u_out, dtype=f64)[None],
                                    TS))
    if launches != dict(K1=0, K2=0, K3=0, K4=0, K5=0, K6=1, K7=2):
        raise AssertionError(f"surface: JAX's default configuration "
                             f"launched kernels {launches}; K6 once and "
                             f"K7 once a network expected")
    out["mpcc_gaps"] = envelope_gaps("surface, M.MPCC() tick",
                                     states[1][None], states[0][None])
    print(f"surface: M.MPCC() one tick at batch 1 on {card}: ok, "
          f"{tick_ms:.1f} ms (the first tick), launches {launches}")

    # the Husky+Panda's 10-DoF manipulability gradient, float64
    qm = torch.tensor(
        home(mobile_system())[:kmob.NQ_MOBILE]
        + 0.4 * rng.standard_normal((SURFACE_CONFIGS, kmob.NQ_MOBILE)),
        dtype=f64)
    out["grad_err"] = check_close(
        "surface: kinematics_mobile.manipulability_gradient",
        kmob.manipulability_gradient(qm.cuda()).cpu(),
        kmob.manipulability_gradient(qm), SURFACE_GRAD_TOL)

    # the nets' unencoded Jacobian, float64
    errs = []
    for load in (cnn.load_self_collision_nn, cnn.load_env_collision_nn):
        gpu_net, cpu_net = load(f64, "cuda"), load(f64, "cpu")
        xin = torch.tensor(rng.standard_normal(
            (SURFACE_LANES * KNOTS, gpu_net.layers[0].in_features)), dtype=f64)
        got = cnn.mlp_forward_jacobian(gpu_net, xin.cuda(), is_nerf=False)
        ref = cnn.mlp_forward_jacobian(cpu_net, xin, is_nerf=False)
        for g, r, what in zip(got, ref, ("y", "jacobian")):
            scale = max(1.0, float(r.abs().max()))
            errs.append(check_close(
                f"surface: {load.__name__} is_nerf=False {what}", g.cpu(), r,
                SURFACE_JAC_TOL * scale) / scale)
    out["unencoded_rel_err"] = max(errs)

    # RobotData's NN half with bf16 GEMMs (nn_bf16), float32
    qs = torch.tensor(home()[:PANDA.dof] + 0.3 * rng.standard_normal(
        (SURFACE_LANES, KNOTS, PANDA.dof)), dtype=f32)
    obs = torch.tensor(np.array([0.4, 0.0, 0.4]) + 0.2 * rng.standard_normal(
        (SURFACE_LANES, 3)), dtype=f32)
    rad = torch.full((SURFACE_LANES,), 0.03, dtype=f32)
    fields = ("sel_dist", "d_sel_dist", "env_dist", "d_env_dist")

    def nn_blocks(device, mm):
        sel = cnn.load_self_collision_nn(f32, device)
        env = cnn.load_env_collision_nn(f32, device)
        rb = compute_robot_data(qs.to(device), obs.to(device), rad.to(device),
                                sel, env, mani_grad="ad", system=PANDA,
                                kin_backend="xla", nn_mm_dtype=mm)
        return {f: getattr(rb, f).cpu() for f in fields}

    bf16_gpu, bf16_cpu = nn_blocks("cuda", "bfloat16"), nn_blocks(
        "cpu", "bfloat16")
    plain_gpu = nn_blocks("cuda", None)
    errs = []
    for f in fields:
        scale = float(bf16_cpu[f].abs().max())
        errs.append(check_close(f"surface: nn_bf16 {f}", bf16_gpu[f],
                                bf16_cpu[f], SURFACE_BF16_TOL * scale) / scale)
        if torch.equal(bf16_gpu[f], plain_gpu[f]):
            raise AssertionError(f"surface: nn_bf16 left {f} unchanged")
    out["bf16_rel_err"] = max(errs)
    print(f"surface: 10-DoF manipulability gradient (float64, "
          f"{SURFACE_CONFIGS} configurations) max |err| against the CPU "
          f"{out['grad_err']:.3e} (tol {SURFACE_GRAD_TOL}); unencoded NN "
          f"outputs and Jacobians (float64, {SURFACE_LANES * KNOTS} points) "
          f"{out['unencoded_rel_err']:.3e} of scale (tol {SURFACE_JAC_TOL}); "
          f"nn_bf16 RobotData (float32, {SURFACE_LANES} x {KNOTS} knots) "
          f"{out['bf16_rel_err']:.3e} of scale (tol {SURFACE_BF16_TOL:.3e}), "
          f"every block moved by bf16")
    return out


# the interpret phase: RTI ticks of each route
INTERPRET_TICKS = 3
ROBOT_DATA_TOL = 1e-10   # card against CPU, float64, of each field's scale


def interpret_runs(prob, system, batch, cfgs: dict, device) -> dict:
    """``INTERPRET_TICKS`` closed-loop ticks of each configuration from the
    same perturbed states, the counts set to 0 just before each and read
    just after: name -> (host times, ok, states, launches, iterations)."""
    x0 = perturbed_states(batch, torch.float32, device, system)
    runs = {}
    for name, cfg in cfgs.items():
        runs[name] = route_ticks(prob, x0, cfg, INTERPRET_TICKS, system)
        check_ok(f"interpret, {system.name} {name}", runs[name][1],
                 runs[name][2])
    return runs


def state_gaps(states, ref, dof: int) -> dict:
    d = (states - ref).abs()
    return {"q": float(d[..., :dof].max()), "s": float(d[..., dof].max()),
            "vs": float(d[..., dof + 1].max())}


def robot_data_defaults(device, card) -> dict:
    """``compute_robot_data`` with JAX's defaults (the plain kinematics,
    the fd gradient) on the card in float64 against the CPU, both systems,
    every field within ``ROBOT_DATA_TOL`` of its scale; of the kernels only
    K7 runs, once a network (the NN half's route on a CUDA tensor)."""
    from mpcc_manipulator_tpu_torch.models import collision_nn as cnn
    from mpcc_manipulator_tpu_torch.ocp.robot_data import compute_robot_data
    from mpcc_manipulator_tpu_torch.system import PANDA
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for system in (PANDA, mobile_system()):
        qs = torch.tensor(home(system)[:system.dof] + 0.05
                          * rng.standard_normal((BATCH, KNOTS, system.dof)))
        obs = torch.tensor(np.array([0.5, 0.1, 0.4]) + 0.1
                           * rng.standard_normal((BATCH, 3)))
        rad = torch.full((BATCH,), 0.05, dtype=torch.float64)
        got = {}
        for where, dev in (("card", device), ("cpu", "cpu")):
            nets = (cnn.load_self_collision_nn(torch.float64, dev),
                    cnn.load_env_collision_nn(torch.float64, dev))
            reset_counts()
            rb = compute_robot_data(qs.to(dev), obs.to(dev), rad.to(dev),
                                    *nets, system=system)
            want = {k: 2 if k == "K7" and where == "card" else 0
                    for k in read_counts()}
            if read_counts() != want:
                raise AssertionError(f"interpret: RobotData with JAX's "
                                     f"defaults launched {read_counts()}, "
                                     f"expected {want}")
            got[where] = {
                f.name: getattr(rb, f.name).cpu()
                for f in dataclasses.fields(rb)}
        err = 0.0
        for name, ref in got["cpu"].items():
            scale = max(1.0, float(ref.abs().max()))
            err = max(err, check_close(
                f"interpret: RobotData defaults {system.name} {name}",
                got["card"][name], ref, ROBOT_DATA_TOL * scale) / scale)
        out[system.name] = err
    print(f"interpret: compute_robot_data with JAX's defaults (fd, plain "
          f"kinematics) float64 on {card} at ({BATCH}, {KNOTS}) knots "
          f"against the CPU: max |err| of scale "
          + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
          + f" (tol {ROBOT_DATA_TOL}); K7 alone launched, once a "
          f"network")
    return out


def phase_interpret(problem, mproblem, device, card) -> dict:
    """JAX's interpret switches as named routes (docstring, item 24)."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.system import PANDA
    out = {}
    ticks = INTERPRET_TICKS
    cfgs = {flag: SQPConfig(ipm_interpret=flag) for flag in (None, True,
                                                               False)}
    for name, system, prob in (("panda", PANDA, problem),
                               ("husky_panda", mobile_system(), mproblem)):
        batch = ROUTE_BATCHES[name]
        runs = interpret_runs(prob, system, batch, cfgs, device)
        _, ok_n, st_n, l_n, it_n = runs[None]
        _, _, st_t, l_t, _ = runs[True]
        _, ok_f, st_f, l_f, it_f = runs[False]
        bench = dict(K1=ticks, K2=ticks, K3=ticks, K4=ticks, K5=0, K6=ticks,
                     K7=2 * ticks)
        if l_n != bench or l_f != bench:
            raise AssertionError(f"interpret, {name}: launches None {l_n}, "
                                 f"False {l_f}, expected {bench}")
        if any(l_t.values()):
            raise AssertionError(f"interpret, {name}: ipm_interpret=True "
                                 f"launched {l_t}")
        if not (torch.equal(st_f, st_n) and torch.equal(ok_f, ok_n)
                and all(torch.equal(a, b) for a, b in zip(it_f, it_n))):
            raise AssertionError(f"interpret, {name}: ipm_interpret=False "
                                 "is not bit-identical to None")
        gaps = state_gaps(st_t, st_n, system.dof)
        if any(gaps[k] >= ENVELOPE[k] for k in ENVELOPE):
            raise AssertionError(f"interpret, {name}: the plain versions' "
                                 f"states leave the kernels' by {gaps} "
                                 f"(envelope {ENVELOPE})")
        med = {str(k): statistics.median(v[0][1:]) * 1e3
               for k, v in runs.items()}
        print(f"interpret, {name} {batch} x {ticks} RTI ticks on {card}: all "
              f"ok; median tick ms None {med['None']:.3f}, True "
              f"{med['True']:.3f}, False {med['False']:.3f}; launches None "
              f"{l_n}, True {l_t}, False {l_f}; False bit-identical to "
              f"None; True against None max |dq| {gaps['q']:.3e}, |ds| "
              f"{gaps['s']:.3e}, |dvs| {gaps['vs']:.3e} (envelope)")
        out[name] = dict(tick_ms=med, gaps=gaps)

    # K5: qp_backend "pallas_interpret" against "pallas", ADMM RTI
    admm = {b: SQPConfig(**dict(ADMM_RTI, qp_backend=b))
            for b in ("pallas", "pallas_interpret")}
    runs = interpret_runs(problem, PANDA, BATCH, admm, device)
    l_k, l_p = runs["pallas"][3], runs["pallas_interpret"][3]
    if l_k != dict(K1=0, K2=0, K3=0, K4=ticks, K5=2 * ticks, K6=ticks,
                   K7=2 * ticks) \
            or l_p != dict(l_k, K5=0):
        raise AssertionError(f"interpret, ADMM: launches pallas {l_k}, "
                             f"pallas_interpret {l_p}")
    gaps = state_gaps(runs["pallas_interpret"][2], runs["pallas"][2],
                      PANDA.dof)
    if any(gaps[k] >= ENVELOPE[k] for k in ENVELOPE):
        raise AssertionError(f"interpret, ADMM: K5's plain version leaves "
                             f"the kernel's states by {gaps}")
    med = {b: statistics.median(v[0][1:]) * 1e3 for b, v in runs.items()}
    print(f"interpret, ADMM RTI {BATCH} x {ticks} ticks on {card}: all ok; "
          f"median tick ms pallas {med['pallas']:.3f}, pallas_interpret "
          f"{med['pallas_interpret']:.3f}; launches pallas {l_k}, "
          f"pallas_interpret {l_p}; max |dq| {gaps['q']:.3e}, |ds| "
          f"{gaps['s']:.3e}, |dvs| {gaps['vs']:.3e} (envelope)")
    out["admm"] = dict(tick_ms=med, gaps=gaps)
    out["robot_data"] = robot_data_defaults(device, card)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpcc_manipulator_tpu_torch.ops import cuda_build
    from mpcc_manipulator_tpu_torch.problem import build_problem
    from mpcc_manipulator_tpu_torch.timing import card_line

    t_start = time.perf_counter()
    phase_seconds = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    path, log = cuda_build.build()
    cuda_build.library()
    print(f"built {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_seconds[name] = time.perf_counter() - t0
        print(f"[phase {name}: {phase_seconds[name]:.1f} s]", flush=True)
        return out

    problem = build_problem(torch.float32, device)
    aproblem = assembly_problem(device)
    kernels = timed("kernels K1-K7", lambda: [
        phase_k1(problem, device), phase_k2(problem, aproblem, device),
        phase_k3(problem, aproblem, device), phase_k4(device),
        phase_k5(problem, device), *phase_k6(device), *phase_k7(device)])
    mproblem = build_problem(torch.float32, device, system=mobile_system())
    mkernels = timed("kernels -h / -m", lambda: [
        phase_k1_mobile(mproblem, device),
        *phase_k23_mobile(mproblem, device), phase_k4_mobile(device)])
    mobile = timed("Husky+Panda RTI",
                   lambda: phase_mobile_rti(mproblem, device, card))
    for k in mkernels:
        k["launches"] = mobile["launches"][k["name"][:2]]
    # each path's kernels carry the launches of that path's own run
    x0, states, launches = timed(
        "RTI", lambda: phase_closed_loop(problem, device, card))
    states_conv, inputs = timed(
        "converged", lambda: phase_converged(problem, x0, card))
    states_meh, iters_meh, inputs_meh, launches_meh, solves_meh = timed(
        "Mehrotra RTI", lambda: phase_mehrotra_rti(problem, x0, card))
    states_admm, inputs_admm, launches_admm = timed(
        "ADMM RTI", lambda: phase_admm_rti(problem, x0, card))
    for k in kernels:
        name = k["name"][:2]
        k["launches"] = (launches_admm if name == "K5" else launches)[name]
    kernels[0]["mehrotra_launches"] = launches_meh["K1"]
    timed("ADMM converged", lambda: phase_admm_converged(problem, x0, card))
    timed("CPU checks", lambda: (
        phase_cpu_check_rti(x0, states),
        phase_cpu_check_mehrotra(x0, inputs_meh, states_meh, iters_meh,
                                 solves_meh),
        phase_cpu_check_converged(inputs, states_conv),
        phase_cpu_check_admm(inputs_admm, states_admm),
        phase_cpu_check_mobile(mobile["inputs"], mobile["states"],
                               mobile["iters"])))
    horizon_ms = timed("horizons", lambda: phase_horizons(
        problem, mproblem, device, card))
    kernels[0]["horizon_device_ms"] = horizon_ms["panda"]
    mkernels[0]["horizon_device_ms"] = horizon_ms["husky_panda"]
    timed("plain RobotData",
          lambda: phase_plain_robot_data(problem, device, card))
    timed("closed_loop_scan", lambda: phase_scan(problem, device, card))
    timed("api.MPCC", lambda: phase_api(card))
    timed("native", phase_native)
    timed("checkpoint", lambda: phase_checkpoint(problem, device, card))
    timed("sim_bridge", lambda: phase_bridge(card, device))
    timed("demos", lambda: phase_demos(card, device))
    timed("gates", lambda: phase_gates(card, device))
    timed("sharded", lambda: phase_sharded(problem, mproblem, device, card))
    timed("routes", lambda: phase_routes(problem, mproblem, device, card))
    timed("surface", lambda: phase_surface(card))
    timed("interpret", lambda: phase_interpret(problem, mproblem, device,
                                               card))
    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_seconds.items()))

    print(f"command time {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels + mkernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
