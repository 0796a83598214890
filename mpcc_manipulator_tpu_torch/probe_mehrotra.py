"""How far K1's float32 Mehrotra solves leave float64's Newton count, beside
the plain float32 solve and beside variants of K1's own rounding, on one
GPU.

    python -m mpcc_manipulator_tpu_torch.probe_mehrotra

Drives the Panda's Mehrotra RTI loop (1024 scenarios from the home state
+ 0.01 N(0,1), 10 ticks, ``SQPConfig(ipm_scheme="mehrotra")``) and keeps
every K1 call's QP and warm start.  Each of the 10,240 QPs is then solved
in float64 by the plain version on the CPU, and in float32 by:

* K1 as built from ``csrc/``;
* the plain version on the card, and on the CPU;
* the plain version on the card with K1's form of the Riccati P update,
  ``P = q_bar - Y'Y`` with ``Y = L^-1 s_bar``, in place of
  ``sym(q_bar + s_bar' K)``;
* K1 rebuilt from a copy of ``csrc/`` with one change each: without FMA
  contraction (``--fmad=false``); with the Mehrotra gradient blocks built
  by the tile pass that the adaptive scheme uses; with IEEE ``1 / sqrtf``
  in place of the ``rsqrtf`` Cholesky pivots; the first two together;
  with K1's Mehrotra-only code in the plain solve's summation order and
  roundings (``_PLAIN_ORDER``);
  with Mehrotra's saved factorization held in float64 (``-DMPCC_FACT_F64``:
  r_bar factored again in float64 for it, and the vector sweeps'
  triangular solves against it in float64); and with the vector sweeps'
  whole recursion in float64 beside it (``-DMPCC_VSWEEP_F64``).

For each, the QPs whose Newton count differs from float64's and the
largest |d du|.  Then, on one QP where K1 splits and the plain solve does
not (tick 4, lane 5), each solve stopped after 1, 2, ... iterations: its
distance from float64's iterate, iteration by iteration.  The variant
builds go to ``build/probe_mehrotra/``; ``--variant NAME`` (repeatable)
builds only those.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from .models.dynamics import sim_time_step
from .mpc import init_carry, mpc_step
from .ops import cuda_build
from .params import SQPConfig
from .problem import X0_HOME, build_problem
from .solver import qp_ipm
from .solver import qp_ipm_kernel
from .solver import sqp as sqp_mod
from .solver.qp_ipm_kernel import solve_qp_ipm_k, solve_qp_ipm_plain
from .utils.linalg_small import cho_solve_small, cholesky_small

BATCH, TICKS, TS = 1024, 10, 0.01
TRACE = (4, 5)          # (tick, lane) of the iteration-by-iteration trace
_GRADIENT_PASS = "      gradient_blocks(c);\n"
# The plain solve's (`solver/qp_ipm.py`) order and roundings in the
# Mehrotra-only code of K1: the gradient rows w (s - d) + rhs / s and the
# corrector's right-hand side with the product rounded apart; each gradient
# block as g + (C' r over C's rows), then the box terms, each product rounded
# apart; in the vector sweep the a_sv coupling rounded apart and the
# triangular solves against L as `cho_solve_small` takes them (right-looking:
# the backward half subtracts from the last row up; products rounded apart;
# a division by L's diagonal).  The adaptive scheme's code is untouched.
_PLAIN_ORDER = [
    ("    c.cz[i] = c.w[i] * (sv - c.d[i]) + rhs / ss;\n",
     "    c.cz[i] = rhs_mode == 1 ? c.w[i] * (sv - c.d[i]) + rhs / ss\n"
     "        : __fadd_rn(__fmul_rn(c.w[i], sv - c.d[i]), rhs / ss);\n"),
    ("        c.tp[Q_UP + e] = __ldg(c.gx + c.n_st * NX + e)\n"
     "                       + c.tx[e] * (gl[O_XU + e] - gl[O_XL + e]);\n",
     "        c.tp[Q_UP + e] = __fadd_rn(__ldg(c.gx + c.n_st * NX + e),\n"
     "            __fmul_rn(c.tx[e], gl[O_XU + e] - gl[O_XL + e]));\n"),
    ("        v = __ldg(c.gx + k * NX + e);\n"
     "        if (k >= 1) v += c.tx[e] * (gk[O_XU + e - NC] - gk[O_XL + e - NC]);\n"
     "        for (int r = 0; r < NPC; ++r) v += __ldg(cx + r * NX + e) * gk[O_P + r];\n",
     "        float pr = 0.f;\n"
     "        for (int r = 0; r < NPC; ++r) pr += __ldg(cx + r * NX + e) * gk[O_P + r];\n"
     "        v = __fadd_rn(__ldg(c.gx + k * NX + e), pr);\n"
     "        if (k >= 1) v = __fadd_rn(v, __fmul_rn(c.tx[e],\n"
     "            gk[O_XU + e - NC] - gk[O_XL + e - NC]));\n"),
    ("        v = __ldg(c.gxu + k * DOF + u)\n"
     "            - c.tr[u] * (gk[O_RU + u] - gk[O_RL + u]);\n",
     "        v = __fsub_rn(__ldg(c.gxu + k * DOF + u),\n"
     "            __fmul_rn(c.tr[u], gk[O_RU + u] - gk[O_RL + u]));\n"),
    ("        v = __ldg(c.gu + k * NU + u) + c.tu[u] * (gk[O_UU + u] - gk[O_UL + u]);\n"
     "        if (u < DOF) v += c.tr[u] * (gk[O_RU + u] - gk[O_RL + u]);\n"
     "        for (int r = 0; r < NPC; ++r) v += __ldg(cu + r * NU + u) * gk[O_P + r];\n",
     "        float pr = 0.f;\n"
     "        for (int r = 0; r < NPC; ++r) pr += __ldg(cu + r * NU + u) * gk[O_P + r];\n"
     "        v = __fadd_rn(__ldg(c.gu + k * NU + u), __fadd_rn(\n"
     "            __fmul_rn(c.tu[u], gk[O_UU + u] - gk[O_UL + u]), pr));\n"
     "        if (u < DOF) v = __fadd_rn(v, __fmul_rn(c.tr[u],\n"
     "            gk[O_RU + u] - gk[O_RL + u]));\n"),
    ("          c.r[i] = sigma_m * mu_meas - c.r[i] * c.cz[i];\n",
     "          c.r[i] = __fsub_rn(sigma_m * mu_meas, __fmul_rn(c.r[i], c.cz[i]));\n"),
    ("V(0));\n      if (lane == VS_IDX) qx += c.a_sv * ms;\n",
     "V(0));\n      if (lane == VS_IDX) qx = __fadd_rn(qx, __fmul_rn(c.a_sv, ms));\n"),
    ("          for (int j = 0; j < i; ++j) acc -= fk[F_L + i * NU + j] * z[j];\n"
     "          z[i] = acc * fk[F_LINV + i];\n",
     "          for (int j = 0; j < i; ++j)\n"
     "            acc = __fsub_rn(acc, __fmul_rn(fk[F_L + i * NU + j], z[j]));\n"
     "          z[i] = __fdiv_rn(acc, fk[F_L + i * NU + i]);\n"),
    ("          for (int j = i + 1; j < NU; ++j) acc -= fk[F_L + j * NU + i] * z[j];\n"
     "          z[i] = acc * fk[F_LINV + i];\n",
     "          for (int j = NU - 1; j > i; --j)\n"
     "            acc = __fsub_rn(acc, __fmul_rn(fk[F_L + j * NU + i], z[j]));\n"
     "          z[i] = __fdiv_rn(acc, fk[F_L + i * NU + i]);\n"),
]
VARIANTS = {
    "no FMA contraction": (["--fmad=false"], []),
    "gradient blocks by the tile pass": (
        [], [(_GRADIENT_PASS, "      stage_blocks(c, GQ_OFF, SLOT);\n")]),
    "IEEE 1/sqrt pivots": (
        [], [("linv[j] = rsqrtf(lm[j][j]);",
              "linv[j] = 1.f / sqrtf(lm[j][j]);")]),
    "no FMA contraction, tile pass": (
        ["--fmad=false"],
        [(_GRADIENT_PASS, "      stage_blocks(c, GQ_OFF, SLOT);\n")]),
    "plain summation order": ([], _PLAIN_ORDER),
    "saved factorization in float64": (["-DMPCC_FACT_F64"], []),
    "saved factorization and vector sweeps in float64": (
        ["-DMPCC_FACT_F64", "-DMPCC_VSWEEP_F64"], []),
}
_F64_FLAG = "-DMPCC_FACT_F64"


def _gram_backward(qp, hbar, gbar, hbar_term, gbar_term, with_vectors=True):
    """`qp_ipm._riccati_backward_s` with K1's P update, P = q_bar - Y'Y,
    Y = L^-1 s_bar (matrix sweep only, as Mehrotra runs it)."""
    assert not with_vectors
    bd, a_sv = qp.bd, qp.a_sv[:, None]
    nx, nu = bd.shape[-2:]
    nxt = nx + nu
    s_idx, vs_idx = nx - 2, nx - 1
    bdt = bd.transpose(-1, -2)
    eye_u = torch.eye(nu, dtype=bd.dtype, device=bd.device)
    p_mat = hbar_term
    n_st = hbar.shape[1]
    k_gains, p_xs, chols, s_bars = ([None] * n_st for _ in range(4))
    for k in reversed(range(n_st)):
        h_k = hbar[:, k]
        pa_x = p_mat[:, :, :nx].clone()
        pa_x[:, :, vs_idx] += a_sv * p_mat[:, :, s_idx]
        contrib = pa_x[:, :nx, :].clone()
        contrib[:, vs_idx, :] += a_sv * pa_x[:, s_idx, :]
        q_bar = h_k[:, :nxt, :nxt].clone()
        q_bar[:, :nx, :nx] += contrib
        s_bar = h_k[:, nxt:, :nxt].clone()
        s_bar[:, :, :nx] += bdt @ pa_x[:, :nx, :] + pa_x[:, nx:, :]
        pb = p_mat[:, :, :nx] @ bd + p_mat[:, :, nx:]
        r_bar = h_k[:, nxt:, nxt:] + bdt @ pb[:, :nx, :] + pb[:, nx:, :]
        chol = cholesky_small(r_bar + 1e-9 * eye_u, nu)
        p_xs[k], chols[k], s_bars[k] = p_mat[:, :, :nx], chol, s_bar
        k_gains[k] = -cho_solve_small(chol, s_bar, nu)
        y = torch.linalg.solve_triangular(chol, s_bar, upper=False)
        p_mat = q_bar - y.transpose(-1, -2) @ y
    zeros = [torch.zeros_like(hbar[:, 0, 0, :nu])] * n_st
    return k_gains, zeros, (p_xs, chols, s_bars)


def _cast(qp, fn):
    return type(qp)(**{f.name: fn(getattr(qp, f.name))
                       for f in dataclasses.fields(qp)})


def _f64(t):
    return None if t is None else t.cpu().to(torch.float64)


def _record_loop(dev):
    """The Mehrotra RTI loop's K1 calls: [(QP, warm s, warm lam, result)]."""
    problem = build_problem(torch.float32, dev)
    rng = np.random.default_rng(0)
    x = torch.tensor(X0_HOME[None] + 0.01 * rng.standard_normal((BATCH, 9)),
                     dtype=torch.float32, device=dev)
    u = torch.zeros(BATCH, 8, device=dev)
    carry = init_carry(BATCH, torch.float32, dev)
    obs = torch.tensor([[3.0, 3.0, 3.0]], device=dev).expand(BATCH, 3)
    rad = torch.zeros(BATCH, device=dev)
    calls = []

    def recorded(qp, **kw):
        sol = solve_qp_ipm_k(qp, **kw)
        calls.append((qp, kw["warm_s"], kw["warm_lam"], sol))
        return sol

    sqp_mod.solve_qp_ipm_k = recorded
    try:
        for _ in range(TICKS):
            carry, out = mpc_step(*problem, carry, x, u, obs, rad, ts=TS,
                                  cfg=SQPConfig(ipm_scheme="mehrotra"))
            u = out.u0
            x = sim_time_step(out.x0_updated, u, TS)
    finally:
        sqp_mod.solve_qp_ipm_k = solve_qp_ipm_k
    return calls


def _use_library(src_dir, flags):
    cuda_build._CSRC = src_dir
    cuda_build.NVCC_FLAGS = flags
    cuda_build.library.cache_clear()
    cuda_build.library()


def _variant_dir(name, edits, src):
    """A copy of the kernel sources in ``src`` with ``edits`` made to
    qp_ipm.cu, under build/probe_mehrotra/."""
    tag = name.replace(" ", "_").replace("/", "_").replace(",", "")
    out = os.path.join(os.path.dirname(cuda_build.BUILD_DIR),
                       "probe_mehrotra", tag)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    path = os.path.join(out, "qp_ipm.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: {old!r} not in qp_ipm.cu")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS),
                    help="build only this variant of K1 (repeatable)")
    variants = ap.parse_args().variant or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("probe_mehrotra: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    src0, flags0 = cuda_build._CSRC, list(cuda_build.NVCC_FLAGS)
    calls = _record_loop(dev)
    refs = [solve_qp_ipm_plain(_cast(qp, _f64), warm_s=_f64(ws),
                               warm_lam=_f64(wl), scheme="mehrotra")
            for qp, ws, wl, _ in calls]

    def report(label, solve):
        split, gap, per_tick = 0, 0.0, []
        for (qp, ws, wl, recorded), ref in zip(calls, refs):
            sol = solve(qp, ws, wl, recorded)
            n = int((sol.iters.cpu() != ref.iters).sum())
            split += n
            per_tick.append(n)
            gap = max(gap, float((_f64(sol.du) - ref.du).abs().max()))
        print(f"{label}: Newton count differs from float64 on {split} of "
              f"{BATCH * TICKS} QPs (per tick {per_tick}); max |d du| "
              f"{gap:.3e}", flush=True)

    plain = lambda qp, ws, wl, _: solve_qp_ipm_plain(
        qp, warm_s=ws, warm_lam=wl, scheme="mehrotra")
    kernel = lambda qp, ws, wl, _: solve_qp_ipm_k(
        qp, warm_s=ws, warm_lam=wl, scheme="mehrotra")
    report("K1 as built", lambda qp, ws, wl, recorded: recorded)
    report("plain float32, card", plain)
    report("plain float32, CPU", lambda qp, ws, wl, _: plain(
        _cast(qp, lambda t: t.cpu()), ws.cpu(), wl.cpu(), None))
    backward = qp_ipm._riccati_backward_s
    qp_ipm._riccati_backward_s = _gram_backward
    try:
        report("plain float32, card, P = q_bar - Y'Y", plain)
    finally:
        qp_ipm._riccati_backward_s = backward
    fact_floats = qp_ipm_kernel.fact_floats
    try:
        for name in variants:
            flags, edits = VARIANTS[name]
            _use_library(_variant_dir(name, edits, src0), flags0 + flags)
            # a float64 factorization takes twice the floats of scratch
            qp_ipm_kernel.fact_floats = (
                (lambda system: 2 * fact_floats(system))
                if _F64_FLAG in flags else fact_floats)
            report(f"K1, {name}", kernel)
    finally:
        qp_ipm_kernel.fact_floats = fact_floats
        _use_library(src0, flags0)

    tick, lane = TRACE
    qp, ws, wl, _ = calls[tick]
    one = lambda t: t[lane:lane + 1].contiguous()
    qp1, ws1, wl1 = _cast(qp, one), one(ws), one(wl)
    print(f"tick {tick}, lane {lane}, each solve stopped after j Newton "
          "iterations: max |d du|, |d s|, |d lam| from float64's iterate")
    for j in range(1, 11):
        ref = solve_qp_ipm_plain(_cast(qp1, _f64), max_iter=j,
                                 warm_s=_f64(ws1), warm_lam=_f64(wl1),
                                 scheme="mehrotra")
        row = [f"j {j}: float64 {int(ref.iters[0])} iterations"]
        for label, fn in (("K1", solve_qp_ipm_k),
                          ("plain float32", solve_qp_ipm_plain)):
            sol = fn(qp1, max_iter=j, warm_s=ws1, warm_lam=wl1,
                     scheme="mehrotra")
            gaps = [float((_f64(getattr(sol, f)) - getattr(ref, f)).abs()
                          .max()) for f in ("du", "s_rows", "lam_rows")]
            row.append(f"{label} {int(sol.iters[0])}: "
                       + ", ".join(f"{g:.3e}" for g in gaps))
        print("  " + "; ".join(row), flush=True)
    print(f"probe time {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
