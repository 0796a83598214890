"""Checkpoint/resume for long closed-loop and fleet runs
(`mpcc_manipulator_tpu/runtime/checkpoint.py`).

The whole loop state is explicit: ``(MPCCarry, x, u)`` of tensors, batched
over scenarios, plus the tick.  It is written to one ``.npz`` whose member
names are the JAX package's key paths (``[0].z_guess``, ``[1]``, ...;
tuples and lists ``[i]``, dict keys ``['k']``, dataclass fields ``.name``),
so a checkpoint moves between the two packages: a state the JAX package
saved for a batch of B scenarios restores into the port's template for B
scenarios, and back.  No pickling; plain numpy reads it.

Restore takes a template of the same structure, so structure, shapes and
dtypes are validated against the running program rather than trusted from
disk; the restored tensors land on the template's device.  Writes are
atomic (tmp file + fsync + rename + directory fsync) so a preemption
mid-write never corrupts the previous checkpoint.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from ..utils.tree import flatten_with_path, unflatten

_STEP_KEY = "__step__"


def _flatten_with_names(tree):
    """``[(name, leaf)]`` in the JAX package's key-path order and spelling;
    npz member names must be unique and filesystem-safe."""
    return [(re.sub(r"[^A-Za-z0-9_.\[\]']+", "_", path), leaf)
            for path, leaf in flatten_with_path(tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _numpy_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save_state(path: str, state, step: int) -> None:
    """Atomically write ``state`` (nested tuples, lists, dicts and
    dataclasses of tensors or arrays) and the step counter."""
    named = _flatten_with_names(state)
    arrays = {name: _to_numpy(leaf) for name, leaf in named}
    if len(arrays) != len(named):
        raise ValueError("duplicate keypath names in checkpoint tree")
    arrays[_STEP_KEY] = np.asarray(step, dtype=np.int64)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())   # durable before the rename is visible
        os.replace(tmp, path)
        # fsync the directory so the rename itself survives a crash
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_state(path: str, template):
    """Load a checkpoint into the structure of ``template``.

    Returns ``(state, step)``.  Every leaf is validated against the
    template's shape and dtype; missing or extra arrays are errors, and so
    is a dtype mismatch unless it is an exact-value-preserving widening
    (e.g. a float32 checkpoint into a float64 template).  Tensor leaves
    come back as tensors on the template leaf's device, array leaves as
    numpy arrays.
    """
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    step = int(stored.pop(_STEP_KEY))
    named = _flatten_with_names(template)
    missing = [n for n, _ in named if n not in stored]
    extra = set(stored) - {n for n, _ in named}
    if missing or extra:
        raise ValueError(f"checkpoint/template mismatch: missing={missing} "
                         f"extra={sorted(extra)}")
    leaves = []
    for name, tleaf in named:
        arr = stored[name]
        tshape = tuple(tleaf.shape) if isinstance(tleaf, torch.Tensor) \
            else np.shape(tleaf)
        if tuple(arr.shape) != tuple(tshape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"template shape {tshape}")
        tdtype = _numpy_dtype(tleaf)
        if arr.dtype != tdtype and not np.can_cast(arr.dtype, tdtype,
                                                   casting="safe"):
            raise ValueError(
                f"{name}: checkpoint dtype {arr.dtype} does not safely cast "
                f"to template dtype {tdtype} (lossy restore refused)")
        arr = np.asarray(arr, dtype=tdtype)
        if isinstance(tleaf, torch.Tensor):
            leaves.append(torch.from_numpy(arr).to(tleaf.device))
        else:
            leaves.append(arr)
    return unflatten(template, iter(leaves)), step


def latest_checkpoint(directory: str, prefix: str = "ckpt_"):
    """Path of the highest-step ``{prefix}{step}.npz`` in ``directory``,
    or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    pat = re.compile(re.escape(prefix) + r"(\d+)\.npz$")
    for fn in os.listdir(directory):
        m = pat.match(fn)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(directory, fn)
    return best
