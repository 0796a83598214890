"""Multi-GPU scaling: batched scenario solves split over the ranks of a
``torch.distributed`` process group (`mpcc_manipulator_tpu/parallel/
sharding.py`).

The distributed axis of this system is the batch of scenarios: thousands
of independent (x0, u0, obstacle, carry) tuples solved per tick.  The JAX
package puts them on a 1-D mesh with the axis ``"batch"``, splits the
scenario arrays on their leading axis, replicates the shared tree (track,
parameters, networks) and jits the vmapped tick, which then never crosses
a chip.  Here that is plain data parallelism: one process per rank, each
holding rows ``[r B/W, (r+1) B/W)`` of every scenario tensor on its own
device, and the batch-first ``mpc_step`` run on that slice.  The tick issues
no collective; its batch-wide early exits (``all()`` / ``any()`` over the
lanes a process holds) are host syncs of that process, and every loop
masks per lane, so a lane's result does not depend on its neighbours.
The one cross-rank operation is :func:`fleet_diagnostics`: one
``all_reduce`` of three integers.

The caller initialises the process group (``dist.init_process_group``
with its address, world size and rank), as a JAX caller runs
``jax.distributed.initialize``; :func:`make_mesh` reads it.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch import nn

from ..models import collision_nn as cnn
from ..mpc import MPCCarry, MPCOutput, init_carry, mpc_step
from ..params import MPCCParams, SQPConfig
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from ..utils.tree import flatten_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh as one rank sees it: its place on the axis,
    the axis' size, the device its slice lives on, and the process group
    (None: no collective, as for a mesh of one, or for ranks run in turn in
    one process)."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None
    axis_name: str = "batch"

    def __post_init__(self):
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world_size}")
        device = torch.device(self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", device)


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """This rank's place on the 1-D mesh over the initialised process group
    (world size 1 without one).  ``devices``: one device per rank; the
    default is ``cuda:{local_rank % device_count()}``, with ``LOCAL_RANK``
    as a launcher sets it, else the rank."""
    if dist.is_available() and dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), \
            dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(e.g. ['cpu'] * world_size) for the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a world of "
                             f"{world} ranks")
        device = devices[rank]
    return Mesh(rank, world, device, group, axis_name)


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's "
                         f"{mesh.axis_name!r}")


def batch_init_carry(batch: int, dtype=torch.float32,
                     system: System = PANDA, device="cuda") -> MPCCarry:
    return init_carry(batch, dtype, device, system)


def shard_batch(tree, mesh: Mesh, axis_name: str = "batch"):
    """This rank's rows of every leaf's leading axis, on ``mesh.device``:
    rows ``[r B/W, (r+1) B/W)``.  Raises ``ValueError`` unless the mesh
    divides B evenly."""
    _check_axis(mesh, axis_name)

    def rows(leaf: torch.Tensor) -> torch.Tensor:
        b = leaf.shape[0]
        if b % mesh.world_size:
            raise ValueError(f"a leading axis of {b} does not split evenly "
                             f"over {mesh.world_size} ranks")
        n = b // mesh.world_size
        return leaf[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)

    return tree_map(rows, tree)


def replicate(tree, mesh: Mesh):
    """The shared tree (track, parameters, networks) on ``mesh.device``:
    tensors copied there, modules moved there (``nn.Module.to``, in place),
    other leaves kept as they are."""
    return tree_map(lambda leaf: leaf.to(mesh.device)
                    if isinstance(leaf, (torch.Tensor, nn.Module)) else leaf,
                    tree)


def batched_mpc_step(track: TrackSpline, params: MPCCParams,
                     sel_nn: cnn.CollisionMLP, env_nn: cnn.CollisionMLP,
                     carry: MPCCarry, x0: torch.Tensor, u0: torch.Tensor,
                     obs_pos: torch.Tensor, obs_radius: torch.Tensor,
                     ts: float = 0.01, cfg: SQPConfig = SQPConfig(),
                     exact_heading_jac: bool = False,
                     system: System = PANDA
                     ) -> tuple[MPCCarry, MPCOutput]:
    """The MPC tick over a leading scenario axis: ``mpc_step``, which is
    batch-first already (JAX vmaps its single-scenario step here)."""
    return mpc_step(track, params, sel_nn, env_nn, carry, x0, u0, obs_pos,
                    obs_radius, ts=ts, cfg=cfg,
                    exact_heading_jac=exact_heading_jac, system=system)


def make_sharded_step(mesh: Mesh, ts: float = 0.01,
                      cfg: SQPConfig = SQPConfig(), axis_name: str = "batch",
                      exact_heading_jac: bool = False,
                      system: System = PANDA):
    """The batched step on this rank's slice.

    Returns ``step(track, params, sel_nn, env_nn, carry, x0, u0, obs_pos,
    obs_radius) -> (carry, output)``; the scenario arguments are this rank's
    rows (:func:`shard_batch`), on ``mesh.device`` and of one leading size,
    and so are the outputs.  The step issues no collective.
    """
    _check_axis(mesh, axis_name)

    def step(track, params, sel_nn, env_nn, carry, x0, u0, obs_pos,
             obs_radius):
        scen = flatten_with_path((carry, x0, u0, obs_pos, obs_radius))
        for path, leaf in scen:
            if leaf.device != mesh.device:
                raise ValueError(f"scenario argument {path} is on "
                                 f"{leaf.device}, the mesh's rank on "
                                 f"{mesh.device}")
        sizes = {leaf.shape[0] for _, leaf in scen}
        if len(sizes) != 1:
            raise ValueError(f"scenario arguments of leading sizes "
                             f"{sorted(sizes)}")
        return batched_mpc_step(track, params, sel_nn, env_nn, carry, x0,
                                u0, obs_pos, obs_radius, ts=ts, cfg=cfg,
                                exact_heading_jac=exact_heading_jac,
                                system=system)

    return step


def fleet_diagnostics(ok: torch.Tensor, sqp_iters: torch.Tensor,
                      mesh: Mesh | None = None) -> dict:
    """Fleet-wide solve success rate and mean SQP iterations from this
    rank's lanes: sum(ok), sum(sqp_iters) and the lane count packed into
    one int64 tensor and summed over the mesh's group by one
    ``all_reduce`` (24 bytes), so both means equal the unsharded batch's.

    Takes the mesh, unlike JAX's, which sees the global array: a rank holds
    only its slice.  Without a group (``mesh`` None, or its group None) it
    reduces this process's lanes alone.
    """
    stats = torch.stack([ok.sum().to(torch.int64),
                         sqp_iters.sum().to(torch.int64),
                         torch.tensor(ok.numel(), device=ok.device)])
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(stats, group=mesh.group)
    stats = stats.to(torch.float32)
    return {"success_rate": stats[0] / stats[2],
            "mean_sqp_iters": stats[1] / stats[2]}
