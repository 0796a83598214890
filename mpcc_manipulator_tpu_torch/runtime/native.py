"""ctypes bindings for the native runtime library
(`mpcc_manipulator_tpu/runtime/native.py`; source
``csrc/mpcc_runtime.cpp``, a copy of the JAX package's
``cpp/mpcc_runtime.cpp``).

Provides:
  * :func:`parse_floats` — fast parser for the reference-format weight/bias
    text files (drop-in replacement for numpy.loadtxt on these assets);
  * :class:`TelemetryRing` — non-blocking per-tick logger backed by a
    native SPSC ring buffer with a background flusher thread.

The library builds at first use with ``g++ -O2 -std=c++17 -fPIC -shared``
(the JAX package's ``cpp/Makefile`` flags) into ``build/native/`` at the
repository root, under a name that carries a hash of the source, so an
edited source never loads a stale build.  Every entry point has a
pure-Python fallback so the package works on a machine without a C++
compiler: this is host telemetry, not the device path.  A compile or a
load that fails raises (with the compiler's messages).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "mpcc_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lib = None
_build_failed = False


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmpcc_runtime_{h.hexdigest()[:16]}.so")


class NoCompiler(RuntimeError):
    """No C++ compiler on this machine: the Python fallback runs."""


def build() -> str:
    """Compile the library if this source has none yet; returns its path.
    Raises :class:`NoCompiler` when no C++ compiler is found and
    ``RuntimeError`` with the compiler's messages when the compile
    fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise NoCompiler("no C++ compiler (g++) for the native runtime")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed ({cxx}, exit "
                           f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        path = build()
    except NoCompiler:
        _build_failed = True
        return None
    lib = ctypes.CDLL(path)
    lib.mpcc_parse_floats.restype = ctypes.c_longlong
    lib.mpcc_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
    lib.mpcc_ring_create.restype = ctypes.c_void_p
    lib.mpcc_ring_create.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.mpcc_ring_append.restype = ctypes.c_int
    lib.mpcc_ring_append.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.mpcc_ring_dropped.restype = ctypes.c_ulonglong
    lib.mpcc_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.mpcc_ring_close.restype = None
    lib.mpcc_ring_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def parse_floats(path: str, expected: int | None = None) -> np.ndarray:
    """Parse whitespace-separated doubles from a text file (native fast path,
    numpy fallback)."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path).reshape(-1)
    cap = expected if expected is not None else os.path.getsize(path) // 2 + 16
    out = np.empty(cap, dtype=np.float64)
    n = lib.mpcc_parse_floats(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_longlong(cap))
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n].copy()


class TelemetryRing:
    """Non-blocking telemetry logger (native ring buffer; Python fallback
    buffers in memory and writes on close)."""

    def __init__(self, path: str, record_len: int, capacity: int = 4096,
                 text_mode: bool = False):
        self.record_len = record_len
        self.path = path
        self.text_mode = text_mode
        self._lib = _load()
        self._handle = None
        self._fallback: list[np.ndarray] | None = None
        if self._lib is not None:
            self._handle = self._lib.mpcc_ring_create(
                path.encode(), record_len, capacity, int(text_mode))
        if self._handle is None:
            self._fallback = []

    def append(self, record: np.ndarray) -> bool:
        rec = np.ascontiguousarray(record, dtype=np.float64)
        assert rec.size == self.record_len
        if self._handle is not None:
            return bool(self._lib.mpcc_ring_append(
                self._handle, rec.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        self._fallback.append(rec.copy())
        return True

    @property
    def dropped(self) -> int:
        if self._handle is not None:
            return int(self._lib.mpcc_ring_dropped(self._handle))
        return 0

    def close(self):
        if self._handle is not None:
            self._lib.mpcc_ring_close(self._handle)
            self._handle = None
        elif self._fallback is not None:
            arr = np.stack(self._fallback) if self._fallback else \
                np.zeros((0, self.record_len))
            if self.text_mode:
                np.savetxt(self.path, arr, fmt="%.17g")
            else:
                arr.astype(np.float64).tofile(self.path)
            self._fallback = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
