"""K2 and K3: the stage-QP assembly and the line-search evaluation as CUDA
kernels (`csrc/assembly.cu`), replacing the TPU kernels `_assembly_kernel`
and `_eval_kernel` of `mpcc_manipulator_tpu/ops/pallas_assembly.py`.

:func:`build_qp_stages_k_kernel` assembles the :class:`StageQPK` blocks of
one SQP iteration; :func:`eval_point_kernel` returns the objective and the
l1 constraint violation at one iterate per scenario, or at ``A`` candidate
iterates per scenario (``z`` of shape (B, A, n_var), all against the
scenario's one RobotData: the merit line search's step lengths).  On CUDA
tensors each launches its kernel (or raises); on CPU tensors each runs its
plain version, :func:`build_qp_stages_k_plain` /
:func:`eval_point_plain`.  ``interpret=True`` runs the plain versions on
either device, ``interpret=False`` the kernels only
(`cuda_build.kernel_route`).

The kernels read the track, the parameters and the dynamics from one packed
float32 table (:func:`pack_tables`), built once per ``(track, params, ts)``
and cached on the device.  The cache key holds every tensor of the track
and the parameters by identity and version counter, so a field replaced by
a new tensor or edited in place builds a new table.  The cache entry also
holds what depends on the key alone: the check of the table against the
length the kernels read and of the shared blocks' device, and, per batch
size, the batch-expanded scenario-independent StageQPK blocks and the zero
``hux``.  Every call at one batch returns those same tensors; no consumer
of a StageQPK writes into them (`solver/sqp.py`, `solver/qp_ipm_kernel.py`
and `ocp/qp_stages.py::qpk_to_qps` only read them).

:func:`launch_geometry` mirrors, in Python, how the C entries launch each
kernel (scenarios a block, threads, shared bytes, blocks);
:func:`launch_config` asks the card (the same, with registers, local bytes
and the blocks an SM holds).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ocp import qp_data
from ..ocp import qp_stages as qps
from ..ocp.qp_stages import StageQPK
from ..ocp.robot_data import RobotData
from ..params import MPCCParams
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from . import cuda_build

# scalar slots of the table, in the order `csrc/assembly.cu` reads them
# (the JAX kernel's `_SC_KEYS` plus r_ddq)
SC_KEYS = [
    "delta", "length", "ax_last", "ay_last", "az_last",
    *[f"r_last_{i}" for i in range(9)],
    "q_c", "q_c_N_mult", "q_l", "q_vs", "q_ori", "q_sing", "r_dq", "r_dVs",
    "q_c_red_ratio", "q_l_inc_ratio", "q_ori_red_ratio",
    "tol_selcol", "tol_sing", "tol_envcol",
    "v_des", "deacc_ratio", "s_trust", "r_ddq",
]


# Plain PyTorch version of K2 (any device): the plain assembly itself
build_qp_stages_k_plain = qps.build_qp_stages_k


def eval_point_plain(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                     params: MPCCParams, current_u: torch.Tensor, ts,
                     system: System = PANDA):
    """Plain PyTorch version of K3 (any device): ``(objective, l1
    violation)`` at ``z`` (B, n_var) -> (B,) each, or at ``z`` (B, A,
    n_var) -> (B, A) each, one candidate at a time."""
    if z.dim() == 3:
        outs = [eval_point_plain(track, z[:, a], rb, params, current_u, ts,
                                 system) for a in range(z.shape[1])]
        return (torch.stack([o for o, _ in outs], 1),
                torch.stack([v for _, v in outs], 1))
    obj = qp_data.total_objective(track, z, rb, params, system=system)
    constr, lo, hi = qp_data.constraint_values(track, z, rb, params,
                                               current_u, ts, system)
    return obj, qp_data.constraint_norm(constr, lo, hi)


def pack_tables(track: TrackSpline, params: MPCCParams, ts,
                system: System = PANDA) -> torch.Tensor:
    """The kernels' shared float32 table, on the track's device:
    ``[scalars (SC_KEYS) | t_x | t_u | x_l | x_u | u_l | u_u | ddq_l |
    ddq_u | Ad (nx*nx) | Bd (nx*nu) | position coefficients (nseg, 12) |
    rotation table (nseg-1, 14)]``."""
    m, c, bnd = params.model, params.cost, params.bounds
    nrm = params.normalization
    f64 = lambda t: torch.as_tensor(t).detach().to("cpu", torch.float64)
    r_last = f64(track.sr.r[-1]).reshape(9)
    scal = dict(
        delta=track.sx.delta, length=track.length, ax_last=track.sx.a[-1],
        ay_last=track.sy.a[-1], az_last=track.sz.a[-1],
        q_c=c.q_c, q_c_N_mult=c.q_c_N_mult, q_l=c.q_l, q_vs=c.q_vs,
        q_ori=c.q_ori, q_sing=c.q_sing, r_dq=c.r_dq, r_dVs=c.r_dVs,
        q_c_red_ratio=c.q_c_red_ratio, q_l_inc_ratio=c.q_l_inc_ratio,
        q_ori_red_ratio=c.q_ori_red_ratio, tol_selcol=m.tol_selcol,
        tol_sing=m.tol_sing, tol_envcol=m.tol_envcol,
        v_des=m.desired_ee_velocity, deacc_ratio=m.deacc_ratio,
        s_trust=m.s_trust_region, r_ddq=c.r_ddq,
        **{f"r_last_{i}": r_last[i] for i in range(9)})
    ad, bd = qp_data._discrete_ab(ts, torch.float64, "cpu", system)
    ptbl = torch.stack([f64(getattr(getattr(track, ch), f))
                        for ch in ("sx", "sy", "sz")
                        for f in ("a", "b", "c", "d")], dim=1)
    nseg = ptbl.shape[0]
    rtbl = torch.cat([f64(track.sr.r[:nseg - 1]).reshape(nseg - 1, 9),
                      f64(track.sr.omega), f64(track.sr.c)[:, None],
                      f64(track.sr.d)[:, None]], dim=1)
    parts = [torch.stack([f64(scal[k]).reshape(()) for k in SC_KEYS])]
    parts += [f64(v).reshape(-1) for v in (
        nrm.t_x, nrm.t_u, bnd.x_l, bnd.x_u, bnd.u_l, bnd.u_u, bnd.ddq_l,
        bnd.ddq_u, ad, bd, ptbl, rtbl)]
    return torch.cat(parts).to(torch.float32).to(track.length.device)


def _shared_blocks(params: MPCCParams, ts, system: System):
    """The scenario-independent StageQPK blocks (as in
    `ocp/qp_stages.py::build_qp_stages_k`): a_sv, bd, tx, tu, t_rate, r2."""
    tx, tu = params.normalization.t_x, params.normalization.t_u
    dtype, dev = tx.dtype, tx.device
    dof, n_h = system.dof, system.horizon
    tx_inv = params.normalization.t_x_inv
    tudq = tu[:dof]
    a_sv = (torch.tensor(float(ts), dtype=dtype, device=dev)
            * tx[system.vs_idx] * tx_inv[system.s_idx])
    _, bd_raw = qp_data._discrete_ab(ts, dtype, dev, system)
    pair_mask = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                           torch.ones(n_h - 1, dtype=dtype, device=dev)])
    r2 = (2.0 * params.cost.r_ddq * pair_mask)[:, None] * (tudq * tudq)[None]
    return dict(a_sv=a_sv, bd=tx_inv[:, None] * bd_raw * tu[None, :], tx=tx,
                tu=tu, t_rate=tudq / ts, r2=r2)


_CACHE: dict = {}


@functools.cache
def _field_names(cls):
    """A dataclass type's field names; None for any other type."""
    if not dataclasses.is_dataclass(cls):
        return None
    return tuple(f.name for f in dataclasses.fields(cls))


def _stamp(obj, key: list, leaves: list) -> None:
    """Append the state of a tree of dataclasses to ``key``: each dataclass
    node as its type (which fixes its fields), each tensor as (identity,
    version counter; -1 for an inference tensor, which has none), any
    other value as itself.  The tensors are appended to ``leaves``, which
    a cache entry keeps alive so that their identities stay unique."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        try:
            version = obj._version
        except RuntimeError:
            version = -1
        key += (id(obj), version)
        return
    names = _field_names(type(obj))
    if names is None:
        key.append(obj)
        return
    key.append(type(obj))
    for name in names:
        _stamp(getattr(obj, name), key, leaves)


@dataclasses.dataclass
class _Entry:
    """What one (track, parameter state, ts, system) key determines."""

    leaves: list         # the key's tensors, kept alive
    table: torch.Tensor  # pack_tables
    shared: dict         # _shared_blocks, unexpanded
    checked: set = dataclasses.field(default_factory=set)  # (sid, device)
    per_batch: dict = dataclasses.field(default_factory=dict)


def _entry(track: TrackSpline, params: MPCCParams, ts,
           system: System) -> _Entry:
    key, leaves = [float(ts), system], []
    _stamp(track, key, leaves)
    _stamp(params, key, leaves)
    key = tuple(key)
    hit = _CACHE.get(key)
    if hit is None:
        hit = _Entry(leaves, pack_tables(track, params, ts, system),
                     _shared_blocks(params, ts, system))
        if not any(t.is_inference() for t in leaves):
            if len(_CACHE) >= 8:
                _CACHE.clear()
            _CACHE[key] = hit
    return hit


def tables(track: TrackSpline, params: MPCCParams, ts,
           system: System = PANDA):
    """(packed table, shared blocks) for this track and parameter state,
    cached while every tensor of both is the same object at the same
    version (an inference tensor has no version counter: never cached)."""
    hit = _entry(track, params, ts, system)
    return hit.table, hit.shared


def _cached(track: TrackSpline, params: MPCCParams, ts, system: System,
            sid: int, dev) -> _Entry:
    """:func:`tables`' entry, checked once against the length the system's
    kernel instantiation reads and the device."""
    hit = _entry(track, params, ts, system)
    if (sid, dev) not in hit.checked:
        want = cuda_build.library().mpcc_assembly_table_len(
            sid, track.sx.a.shape[0])
        if hit.table.numel() != want:
            raise AssertionError(f"assembly table: {hit.table.numel()} "
                                 f"floats, the kernels read {want}")
        for name, t in [("track", hit.table), *hit.shared.items()]:
            cuda_build.check_tensor(f"{name} table", t, t.shape, dev)
        hit.checked.add((sid, dev))
    return hit


def batch_blocks(hit: _Entry, b: int, system: System) -> dict:
    """The entry's shared blocks expanded to ``b`` scenarios, and the zero
    ``hux``: made once per batch size (the two latest kept)."""
    out = hit.per_batch.get(b)
    if out is None:
        tx = hit.shared["tx"]
        out = {k: v.expand((b,) + v.shape).contiguous()
               for k, v in hit.shared.items()}
        out["hux"] = torch.zeros(b, system.horizon, system.nu, system.nx,
                                 dtype=tx.dtype, device=tx.device)
        if len(hit.per_batch) >= 2:
            hit.per_batch.pop(next(iter(hit.per_batch)))
        hit.per_batch[b] = out
    return out


def _robot_inputs(rb: RobotData, b: int, k: int, dev, fields,
                  system: System) -> list:
    """The RobotData fields a kernel reads, checked; the obstacle radius is
    the scenario's (every knot carries the same one), as (B,)."""
    dof, nl = system.dof, system.num_links
    shapes = dict(ee_pos=(b, k, 3), ee_rot=(b, k, 3, 3), jv=(b, k, 3, dof),
                  jw=(b, k, 3, dof), manipul=(b, k), d_manipul=(b, k, dof),
                  sel_dist=(b, k), d_sel_dist=(b, k, dof),
                  env_dist=(b, k, nl), d_env_dist=(b, k, nl, dof))
    out = []
    for f in fields:
        t = getattr(rb, f)
        cuda_build.check_tensor(f"RobotData.{f}", t, shapes[f], dev)
        out.append(t)
    if tuple(rb.obs_radius.shape) != (b, k):
        raise ValueError(f"RobotData.obs_radius: need ({b}, {k}), got "
                         f"{tuple(rb.obs_radius.shape)}")
    radius = rb.obs_radius[:, 0]
    cuda_build.check_tensor("RobotData.obs_radius[:, 0]", radius, (b,), dev)
    return out + [radius]


_K2_ROBOT = ("ee_pos", "ee_rot", "jv", "jw", "manipul", "d_manipul",
             "sel_dist", "d_sel_dist", "env_dist", "d_env_dist")
_K3_ROBOT = ("ee_pos", "ee_rot", "manipul", "d_manipul", "sel_dist",
             "d_sel_dist", "env_dist", "d_env_dist")
_K2_OUT = ("hxx", "huu", "gx", "gu", "gxu", "e", "d_xu", "d_xl", "d_uu",
           "d_ul", "d_ru", "d_rl", "d_p", "cpx", "cpu")


def build_qp_stages_k_kernel(track: TrackSpline, z: torch.Tensor,
                             rb: RobotData, params: MPCCParams,
                             current_u: torch.Tensor, ts,
                             exact_heading_jac: bool = False,
                             system: System = PANDA,
                             interpret: bool | None = None) -> StageQPK:
    """Assemble the batch's StageQPK: K2 on CUDA, the plain version on CPU
    (``interpret``: the route, `cuda_build.kernel_route`).

    ``z`` (B, n_var), ``current_u`` (B, nu), ``rb`` over the N+1 knots."""
    dev = z.device
    if cuda_build.kernel_route(interpret, dev,
                               "build_qp_stages_k_kernel") == "plain":
        return build_qp_stages_k_plain(track, z, rb, params, current_u, ts,
                                       exact_heading_jac, system)
    sid = cuda_build.system_id(system, "K2", dev)
    nx, nu, dof, npc = system.nx, system.nu, system.dof, system.npc
    n_h = system.horizon
    b = z.shape[0]
    cuda_build.check_tensor("z", z, (b, system.n_var), dev)
    cuda_build.check_tensor("current_u", current_u, (b, nu), dev)
    robot = _robot_inputs(rb, b, n_h + 1, dev, _K2_ROBOT, system)
    hit = _cached(track, params, ts, system, sid, dev)
    kw = dict(dtype=torch.float32, device=dev)
    shapes = dict(hxx=(n_h + 1, nx, nx), huu=(n_h, nu, nu), gx=(n_h + 1, nx),
                  gu=(n_h, nu), gxu=(n_h, dof), e=(n_h, nx), d_xu=(n_h, nx),
                  d_xl=(n_h, nx), d_uu=(n_h, nu), d_ul=(n_h, nu),
                  d_ru=(n_h, dof), d_rl=(n_h, dof), d_p=(n_h, npc),
                  cpx=(n_h, npc, nx), cpu=(n_h, npc, nu))
    outs = {f: torch.empty((b,) + shapes[f], **kw) for f in _K2_OUT}
    cuda_build.launch(
        "K2", "mpcc_assembly", z.data_ptr(), current_u.data_ptr(),
        *[t.data_ptr() for t in robot], hit.table.data_ptr(),
        *[outs[f].data_ptr() for f in _K2_OUT],
        sid, b, n_h, track.sx.a.shape[0], float(ts),
        -1.0 if exact_heading_jac else 1.0, device=dev,
        detail="assembly kernel")
    return StageQPK(**batch_blocks(hit, b, system), **outs)


def eval_point_kernel(track: TrackSpline, z: torch.Tensor, rb: RobotData,
                      params: MPCCParams, current_u: torch.Tensor, ts,
                      system: System = PANDA,
                      interpret: bool | None = None):
    """``(objective, l1 violation)`` at ``z`` (B, n_var) -> (B,) each, or
    at ``A`` candidates per scenario, ``z`` (B, A, n_var) -> (B, A) each:
    K3 on CUDA, the plain version on CPU (``interpret``: the route,
    `cuda_build.kernel_route`)."""
    dev = z.device
    if cuda_build.kernel_route(interpret, dev, "eval_point_kernel") == "plain":
        return eval_point_plain(track, z, rb, params, current_u, ts, system)
    sid = cuda_build.system_id(system, "K3", dev)
    if z.dim() not in (2, 3):
        raise ValueError(f"eval_point_kernel: z must be (B, n_var) or "
                         f"(B, A, n_var), got {tuple(z.shape)}")
    b = z.shape[0]
    n_cand = z.shape[1] if z.dim() == 3 else 1
    cuda_build.check_tensor("z", z, tuple(z.shape[:-1]) + (system.n_var,),
                            dev)
    cuda_build.check_tensor("current_u", current_u, (b, system.nu), dev)
    robot = _robot_inputs(rb, b, system.horizon + 1, dev, _K3_ROBOT,
                          system)
    table = _cached(track, params, ts, system, sid, dev).table
    obj = torch.empty(z.shape[:-1], dtype=torch.float32, device=dev)
    vio = torch.empty_like(obj)
    cuda_build.launch(
        "K3", "mpcc_eval_point", z.data_ptr(), current_u.data_ptr(),
        *[t.data_ptr() for t in robot], table.data_ptr(),
        obj.data_ptr(), vio.data_ptr(), sid, b, n_cand, system.horizon,
        track.sx.a.shape[0], float(ts), device=dev, detail="eval kernel")
    return obj, vio


# How the C entries launch K2 and K3 (`csrc/assembly.cu`): a block holds at
# most MAX_SCENARIOS scenarios in at most SMEM_LIMIT bytes of shared memory;
# K2 runs K2_THREADS threads a block, K3 one thread a (candidate row, knot),
# aiming at K3_ROW_THREADS and at most K3_MAX_THREADS.
SMEM_LIMIT = 48 * 1024
K2_THREADS = 256
MAX_SCENARIOS = 4
K3_ROW_THREADS = 128
K3_MAX_THREADS = 256
_GEOMETRY = ("scenarios_per_block", "rows_per_block", "threads",
             "shared_bytes", "blocks")
_LAUNCH = _GEOMETRY + ("blocks_per_sm", "registers", "local_bytes", "sms")


def _smem_floats(kernel: int, system: System, n_h: int, rows: int,
                 ns: int) -> int:
    """Shared floats of one block of ``rows`` rows from ``ns`` scenarios
    (``K2Layout`` / ``K3Layout`` in `csrc/assembly.cu`)."""
    nx, nu, dof = system.nx, system.nu, system.dof
    npc, nl = system.npc, system.num_links
    nk, nvar = n_h + 1, nx * (n_h + 1) + nu * n_h
    head = len(SC_KEYS) + 3 * nx + 3 * nu + 2 * dof + nx * nx + nx * nu
    head = (head + 3) // 4 * 4
    if kernel == 2:
        rec = 4 * ((3 * nx + 1) | 1)
        return ((head + ns * (nvar + nu) + 3) // 4 * 4
                + ns * (nk * rec + 2 * n_h * npc)
                + max(ns * nk * (7 * dof + 14 + nl) + ns,
                      ns * n_h * npc * dof))
    return head + rows * nvar + ns * (nu + nk * (14 + nl) + 1) + 2 * rows * nk


def launch_geometry(kernel: int, system: System = PANDA, n_h: int = None,
                    n_cand: int = 1, batch: int = 1) -> dict:
    """K2's (``kernel`` 2) or K3's (3) launch at horizon ``n_h`` (the
    system's by default), ``n_cand`` candidates a scenario (K3) and
    ``batch`` scenarios, as the C entries compute it: scenarios a block
    (K3: the scenarios its rows span, at most), rows a block (K2: the
    scenarios), threads a block, shared bytes a block, blocks.  Raises
    ``ValueError`` where no block fits."""
    n_h = system.horizon if n_h is None else n_h
    nk = n_h + 1
    fits = lambda rows, ns: 4 * _smem_floats(kernel, system, n_h, rows,
                                             ns) <= SMEM_LIMIT
    if kernel == 2:
        ns = next((s for s in range(MAX_SCENARIOS, 0, -1) if fits(s, s)), 0)
        rows, threads = ns, K2_THREADS
    elif kernel == 3 and n_cand >= 1:
        if n_cand * nk <= K3_ROW_THREADS:
            top = min(MAX_SCENARIOS, K3_ROW_THREADS // (n_cand * nk))
            ns = next((s for s in range(top, 0, -1)
                       if fits(s * n_cand, s)), 0)
            rows = ns * n_cand
        else:
            ns, rows = 2, max(1, K3_ROW_THREADS // nk)
            rows = rows if fits(rows, ns) else 0
        threads = -(-rows * nk // 32) * 32
        if threads > K3_MAX_THREADS:
            rows = 0
    else:
        raise ValueError(f"launch_geometry: kernel {kernel}, candidates "
                         f"{n_cand}")
    if n_h < 1 or rows < 1:
        raise ValueError(f"K{kernel} at N = {n_h} with {n_cand} candidates: "
                         f"no block fits {SMEM_LIMIT} B of shared memory")
    units = batch * (n_cand if kernel == 3 else 1)
    return dict(scenarios_per_block=ns, rows_per_block=rows, threads=threads,
                shared_bytes=4 * _smem_floats(kernel, system, n_h, rows, ns),
                blocks=-(-units // rows))


def launch_config(kernel: int, system: System = PANDA, n_h: int = None,
                  n_cand: int = 1, batch: int = 1) -> dict:
    """:func:`launch_geometry` as the card reports it
    (`mpcc_assembly_launch_config`), with the blocks an SM holds at once,
    the kernel's registers and local-memory (stack and spill) bytes a
    thread, and the card's SM count."""
    n_h = system.horizon if n_h is None else n_h
    return cuda_build.launch_config(
        "mpcc_assembly_launch_config", _LAUNCH, kernel,
        cuda_build.system_id(system, f"K{kernel}"), n_h, n_cand, batch)
