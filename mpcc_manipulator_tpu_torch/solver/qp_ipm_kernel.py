"""K1: the interior-point QP solve as one CUDA kernel launch
(`csrc/qp_ipm.cu`), replacing the TPU kernel `_ipm_kernel` of
`mpcc_manipulator_tpu/solver/qp_ipm_pallas.py`.

:func:`solve_qp_ipm_k` takes the kernel-direct :class:`StageQPK` blocks.
On CUDA tensors it launches the kernel (or raises); on CPU tensors it runs
the plain version, :func:`solve_qp_ipm_plain` (the structured IPM of
`solver/qp_ipm.py` on the repacked QP); ``interpret=True`` runs the plain
version on either device (`ops/cuda_build.kernel_route`).  Inputs and
outputs keep the JAX wrapper's layout, so the packed ``s_rows`` /
``lam_rows`` carry unchanged from solve to solve.
"""

from __future__ import annotations

import ctypes

import torch

from ..ocp.qp_stages import StageQPK, qpk_to_qps
from ..ops import cuda_build
from ..system import PANDA, System
from .qp_ipm import (EPS_IPM, SCHEMES, IPMSolution, groups_to_rows,
                     rows_to_groups, solve_qp_ipm_s)


def fact_floats(system: System = PANDA) -> int:
    """Floats of Mehrotra's saved factorization per scenario and stage: the
    Cholesky factor L (nu x nu), s_bar's x-columns (nu x nx), P_{k+1} e_k
    (nxt) and 1 / diag(L) (nu); 161 for the Panda, 287 for the
    Husky+Panda."""
    nx, nu = system.nx, system.nu
    return nu * nu + nu * nx + (nx + nu) + nu


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def slot_floats(system: System = PANDA) -> int:
    """Floats of one stage's slot in the kernel's global scratch: the
    P-independent stage blocks (the upper halves of Q_xx and R, S, the rate
    diagonals, the gradients gq and gu), padded to 16 bytes.  The
    Husky+Panda's slots live there (`WIDE` in `csrc/qp_ipm.cu`): 320
    floats.  The Panda's live in shared memory: 0."""
    if system.base_dof == 0:
        return 0
    nx, nu, dof = system.nx, system.nu, system.dof
    return _pad4(nx * (nx + 1) // 2 + nu * nx + nu * (nu + 1) // 2 + dof
                 + (nx + dof) + nu)


def scratch_floats(system: System = PANDA, scheme: str = "adaptive") -> int:
    """Floats per (scenario, stage) of the scratch the wrapper allocates for
    K1 (0: none): the slot (:func:`slot_floats`), then under Mehrotra the
    saved factorization (:func:`fact_floats`, padded to 16 bytes behind a
    slot).  Panda 0 / 161, Husky+Panda 320 / 608 (adaptive / Mehrotra)."""
    fact = fact_floats(system) if scheme == "mehrotra" else 0
    slot = slot_floats(system)
    return slot + _pad4(fact) if slot else fact


_LAUNCH_FIELDS = ("shared_bytes", "threads", "blocks_per_sm", "registers",
                  "local_bytes", "sms")
_INPUT_FIELDS = ("hxx", "hux", "huu", "r2", "gx", "gu", "gxu", "e", "bd",
                 "a_sv", "tx", "tu", "t_rate")


def solve_qp_ipm_plain(qp: StageQPK, max_iter: int = 25,
                       warm_s: torch.Tensor | None = None,
                       warm_lam: torch.Tensor | None = None,
                       system: System = PANDA,
                       scheme: str = "adaptive") -> IPMSolution:
    """Plain PyTorch version of K1 (any device)."""
    return solve_qp_ipm_s(qpk_to_qps(qp, system), max_iter=max_iter,
                          warm_s=warm_s, warm_lam=warm_lam, scheme=scheme)


def _expected_shapes(b: int, n: int, system: System) -> dict:
    nx, nu, dof, npc = system.nx, system.nu, system.dof, system.npc
    return dict(
        hxx=(b, n + 1, nx, nx), hux=(b, n, nu, nx), huu=(b, n, nu, nu),
        r2=(b, n, dof), gx=(b, n + 1, nx), gu=(b, n, nu), gxu=(b, n, dof),
        e=(b, n, nx), bd=(b, nx, nu), a_sv=(b,), tx=(b, nx), tu=(b, nu),
        t_rate=(b, dof), d_xu=(b, n, nx), d_xl=(b, n, nx), d_uu=(b, n, nu),
        d_ul=(b, n, nu), d_ru=(b, n, dof), d_rl=(b, n, dof),
        d_p=(b, n, npc), cpx=(b, n, npc, nx), cpu=(b, n, npc, nu))


def solve_qp_ipm_k(qp: StageQPK, max_iter: int = 25,
                   warm_s: torch.Tensor | None = None,
                   warm_lam: torch.Tensor | None = None,
                   system: System = PANDA,
                   scheme: str = "adaptive",
                   interpret: bool | None = None) -> IPMSolution:
    """Solve a batch of stage QPs: K1 on CUDA, the plain version on CPU.

    ``warm_s``/``warm_lam``: packed (B, N+1, nc_stage) warm-start iterates;
    ``None`` is the cold start (all ones).  ``scheme``: ``"adaptive"`` or
    ``"mehrotra"`` (:func:`~.qp_ipm.solve_qp_ipm_s`).  ``interpret`` names
    the route (`ops/cuda_build.kernel_route`): ``True`` runs the plain
    version on either device, ``False`` the kernel only.
    """
    dev = qp.e.device
    if cuda_build.kernel_route(interpret, dev, "solve_qp_ipm_k") == "plain":
        return solve_qp_ipm_plain(qp, max_iter, warm_s, warm_lam, system,
                                  scheme)
    if scheme not in SCHEMES:
        raise ValueError(f"unknown IPM scheme {scheme!r}; expected one of "
                         f"{SCHEMES}")
    sid = cuda_build.system_id(system, "K1", dev)
    b, n_st = qp.e.shape[:2]
    nx, nc = system.nx, system.nc_stage
    for name, shape in _expected_shapes(b, n_st, system).items():
        cuda_build.check_tensor(f"StageQPK.{name}", getattr(qp, name), shape,
                                dev)
    warm = []
    for w in (warm_s, warm_lam):
        if w is None:
            warm.append(torch.ones(b, n_st, nc, dtype=torch.float32,
                                   device=dev))
            continue
        if w.shape != (b, n_st + 1, nc) or w.device != dev:
            raise ValueError(f"warm start: need ({b}, {n_st + 1}, {nc}) on "
                             f"{dev}, got {tuple(w.shape)} on {w.device}")
        warm.append(rows_to_groups(w.to(torch.float32), nx).contiguous())
    d_cat = torch.cat([qp.d_xu, qp.d_xl, qp.d_uu, qp.d_ul, qp.d_ru, qp.d_rl,
                       qp.d_p], dim=-1).contiguous()

    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(b, n_st + 1, system.nxt, **f32)
    du = torch.empty(b, n_st, system.nu, **f32)
    lam = torch.empty(b, n_st, nc, **f32)
    s = torch.empty(b, n_st, nc, **f32)
    iters = torch.empty(b, dtype=torch.int32, device=dev)
    solved = torch.empty(b, dtype=torch.int32, device=dev)
    mu = torch.empty(b, **f32)
    # the slots (Husky+Panda) and Mehrotra's saved factorization, per
    # scenario and stage (L2-resident)
    per_stage = scratch_floats(system, scheme)
    scratch = torch.empty(b, n_st, per_stage, **f32) if per_stage else None

    ptrs = [getattr(qp, f).data_ptr() for f in _INPUT_FIELDS]
    ptrs += [d_cat.data_ptr(), qp.cpx.data_ptr(), qp.cpu.data_ptr(),
             warm[0].data_ptr(), warm[1].data_ptr()]
    ptrs += [t.data_ptr() for t in (dx, du, lam, s, iters, solved, mu)]
    ptrs.append(None if scratch is None else scratch.data_ptr())
    cuda_build.launch("K1", "mpcc_ipm_solve", *ptrs, sid, b, n_st,
                      int(max_iter), ctypes.c_float(EPS_IPM),
                      SCHEMES.index(scheme), device=dev,
                      detail="qp_ipm kernel")
    return IPMSolution(dx_tilde=dx, du=du, lam=groups_to_rows(lam, 0.0, nx),
                       iters=iters.long(), solved=solved > 0, mu=mu,
                       s_rows=groups_to_rows(s, 1.0, nx),
                       lam_rows=groups_to_rows(lam, 1.0, nx))


def env_rows_active(s_rows: torch.Tensor, lam_rows: torch.Tensor,
                    system: System = PANDA) -> torch.Tensor:
    """Each lane's env-collision rows that bind at a solve's returned
    iterates, summed over the knots: the rows whose dual exceeds its
    slack.  ``s_rows`` / ``lam_rows`` are the packed (B, N+1, nc_stage)
    rows K1 and the plain IPMs return; a knot's env rows are the last
    ``num_links`` of its polytopic group (knots 0..N-1).  (B,) int64."""
    env = slice(system.nc_stage - system.num_links, system.nc_stage)
    return (lam_rows[:, :-1, env] > s_rows[:, :-1, env]).sum((1, 2))


def launch_config(n_st: int = 10, system: System = PANDA) -> dict:
    """How K1's instantiation for ``system`` launches at horizon ``n_st`` on
    the current card, either scheme (one kernel): dynamic shared memory and
    threads per block (one block per scenario), the blocks an SM holds at
    once, the kernel's registers and local-memory bytes (stack and spills)
    per thread, and the card's SM count."""
    return cuda_build.launch_config("mpcc_ipm_launch_config", _LAUNCH_FIELDS,
                                    cuda_build.system_id(system, "K1"), n_st)
