"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, from the sources in this checkout only, into
``build/torch_kernels/`` at the repository root; the library name carries a
hash of the sources, so an edited source never loads a stale build.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build()[0])
    lib.mpcc_kin_sweep.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P]
    lib.mpcc_kin_sweep.restype = _I
    lib.mpcc_ipm_solve.argtypes = ([_P] * 18 + [_P] * 7
                                   + [_I, _I, _I, _F, _P])
    lib.mpcc_ipm_solve.restype = _I
    lib.mpcc_error_string.argtypes = [_I]
    lib.mpcc_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = library().mpcc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
