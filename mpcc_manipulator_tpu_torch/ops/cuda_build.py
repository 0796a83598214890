"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, from the sources in this checkout only, into
``build/torch_kernels/`` at the repository root; the library name carries a
hash of the sources, so an edited source never loads a stale build.
Nothing here runs at import time.

:func:`kernel_route` is the one rule by which every kernel wrapper picks
its kernel or its plain version: JAX's ``interpret`` switch, with the plain
version in the place of the Pallas interpreter.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmpcc_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the kernels if this source state has no library yet.

    Returns ``(library path, compiler log)``; the log holds ptxas's
    per-kernel register / shared-memory / spill report (empty when the
    library was already built).
    """
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{path}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in _sources()]
    try:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src}:\n{log}" for src, p, log
                  in zip(_sources(), procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run([_nvcc(), "-shared", "-o", f"{tag}.tmp", *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{tag}.tmp", path)
    return path, "".join(logs)


# The systems each kernel source is instantiated for, keyed by their dims
# (base_dof, arm_dof, num_links), with the integer the C entries take as
# their system argument: the Panda and the Husky+Panda.
_INSTANTIATIONS = {(0, 7, 9): 0, (3, 7, 9): 3}


def system_id(system, what: str) -> int:
    """The C entries' system argument for ``system``; raises for dims no
    kernel is instantiated for."""
    key = (system.base_dof, system.arm_dof, system.num_links)
    if key not in _INSTANTIATIONS:
        raise NotImplementedError(
            f"{what}: no kernel instantiation for {system.name} (base_dof, "
            f"arm_dof, num_links) = {key}; the kernels are instantiated for "
            f"{sorted(_INSTANTIATIONS)}")
    return _INSTANTIATIONS[key]


INTERPRET = (None, True, False)


def check_interpret(interpret, what: str = "interpret") -> None:
    """Raise ``ValueError`` unless ``interpret`` is one of JAX's three
    values: ``None``, ``True`` or ``False``."""
    if interpret is not None and not isinstance(interpret, bool):
        raise ValueError(f"{what}={interpret!r}: expected one of {INTERPRET}")


def kernel_route(interpret, device, what: str = "kernel") -> str:
    """``"kernel"`` or ``"plain"``: what a wrapper runs for ``interpret`` on
    tensors on ``device``, JAX's ``interpret`` with the plain version in the
    place of the Pallas interpreter.

    * ``None``: the kernel on a CUDA device, the plain version on the CPU
      (JAX: compiled on a TPU, the interpreter elsewhere);
    * ``True``: the plain version on either device (JAX: the interpreter,
      the kernel's arithmetic step by step on any backend);
    * ``False``: the kernel; on the CPU ``ValueError``, as JAX's
      ``interpret=False`` raises off a TPU.

    Any other value raises ``ValueError``.  Another device gets
    ``"kernel"``, which the wrapper refuses unless it is CUDA.  The route
    is the caller's to name: no wrapper gives way to its plain version
    because a build or a launch failed."""
    check_interpret(interpret, f"{what}: interpret")
    if interpret:
        return "plain"
    if torch.device(device).type != "cpu":
        return "kernel"
    if interpret is None:
        return "plain"
    raise ValueError(f"{what}: interpret=False runs the kernel, which needs "
                     "a CUDA device; on the CPU only the plain version runs "
                     "(interpret=None or True)")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Every C entry's (argument types, result type)
_ENTRIES = {
    "mpcc_kin_sweep": ([_P, _P, _I, _I] + [_P] * 7, _I),
    "mpcc_kin_launch_config": ([_I, _I, _P], _I),
    "mpcc_project_vs": ([_P, _I, _P, _I, _P, ctypes.POINTER(_P)] + [_I] * 4
                        + [_P] * 3, _I),
    "mpcc_proj_launch_config": ([_I] * 4 + [_P], _I),
    "mpcc_ipm_solve": ([_P] * 18 + [_P] * 8 + [_I, _I, _I, _I, _F, _I, _P],
                       _I),
    "mpcc_ipm_launch_config": ([_I, _I, _P], _I),
    "mpcc_assembly": ([_P] * 29 + [_I, _I, _I, _I, _F, _F, _P], _I),
    "mpcc_eval_point": ([_P] * 14 + [_I] * 5 + [_F, _P], _I),
    "mpcc_assembly_launch_config": ([_I] * 5 + [_P], _I),
    "mpcc_admm_solve": ([_P] * 17 + [_I] * 5 + [_F] * 4 + [_P], _I),
    "mpcc_admm_solve_cluster": ([_P] * 17 + [_I] * 5 + [_F] * 4 + [_I, _P],
                                _I),
    "mpcc_admm_launch_config": ([_I, _I, _I, _P], _I),
    "mpcc_assembly_table_len": ([_I, _I], _I),
    "mpcc_collision_nn": ([_I, _I, _P, _P, _I, _I, _P, _I, _I, _P, _P]
                          + [_I] * 4 + [_P, _I, _I, _I, _P], _I),
    "mpcc_nn_layout": ([_I, _I, _P], _I),
    "mpcc_nn_launch_config": ([_I, _I, _I, _P], _I),
    "mpcc_error_string": ([_I], ctypes.c_char_p),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call).  An entry the
    library lacks (one built from another tree's sources, by the
    comparison tools) stays unbound."""
    lib = ctypes.CDLL(build()[0])
    for name, (args, res) in _ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def ptxas_lines(log: str, symbols) -> str:
    """ptxas's entry, register and spill lines, from a build log, on the
    kernels whose names hold any of ``symbols``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = any(s in line for s in symbols)
        if keep and ("Compiling entry" in line or "Used" in line
                     or "spill" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return "\n".join(lines)


def use_sources(src_dir: str, symbols=()) -> str:
    """Build (if needed) and load the library from the kernel sources in
    ``src_dir`` in place of this checkout's: another tree's ``csrc/``, or a
    probe's edited copy (the comparison and probe tools; the wrappers call
    whichever library is loaded).  Returns ptxas's lines on the kernels
    named by ``symbols`` when the library was built now."""
    global _CSRC
    _CSRC = src_dir
    library.cache_clear()
    _, log = build()
    library()
    return ptxas_lines(log, symbols)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = library().mpcc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
