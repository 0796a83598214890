"""K2's block shape and K2/K3's phases, probed on one GPU.

    python -m mpcc_manipulator_tpu_torch.probe_k23 [--variants] [--phases]

On the first tick's iterate at the perturbed home states (the Panda at
batch 1024, the Husky+Panda at 4096 and 1024; ``compare_k23.inputs``):

* ``--variants``: K2 built with other block shapes (at most 1, 2 or 4
  scenarios a block; 64, 128 or 256 threads), each held bit-identical to
  the kernel as built, and each one's device time taken in turns (the
  kernel as built first and last);
* ``--phases``: a copy of K2 and K3 whose thread 0 of each block stamps the
  global timer at each phase boundary (K2: staging, phase A, the polytopic
  rows' staging, phase B; K3: staging, the knot terms, the row sums); per
  launch, the per-block median of each phase, the span from the first
  block's start to the last block's end, and the latest block start.

With neither flag, both.  The copies are made from this tree's ``csrc/``
by text edits (each must find its text) into ``build/probe_k23/``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from . import compare_k23 as ck
from .ops import assembly_kernel as ak
from .ops import cuda_build
from .system import HUSKY_PANDA, PANDA
from .timing import device_ms

TS = 0.01
SRC = cuda_build._CSRC
AS_BUILT = (ak.MAX_SCENARIOS, ak.K2_THREADS)
SHAPES = [(4, 128), (2, 128), (1, 128), (2, 256), (1, 64)]
MAX_BLOCKS = 16384

# thread 0 of each block stamps the global timer (ns) at phase p
_CLOCKS = f'''
__device__ unsigned long long g_clk[{MAX_BLOCKS} * 5];
__device__ __forceinline__ void mark(int p) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_clk[blockIdx.x * 5 + p] = t;
  }}
}}
'''
_READ_CLOCKS = '''
extern "C" int mpcc_probe_clocks(unsigned long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_clk, n * sizeof(unsigned long long)));
}
'''
_K2_HEAD = "template <class D>\n__global__ void __launch_bounds__(K2_THREADS)"
_SYNC = "  cp_async_wait_all();\n  __syncthreads();\n"
_K2_END = ("          o[e] = j < DOF ? -poly_d(dk[row * DOF + j], row) * tu[j]"
           " : 0.f;\n        }\n      }\n    }\n  }\n}\n")
_PHASE_EDITS = [
    # K2: 0 start, 1 staged, 2 phase A done, 3 rows staged, 4 end
    (_K2_HEAD, _CLOCKS + _K2_HEAD),
    ("  // ---- 0. stage the block's inputs\n",
     "  mark(0);\n  // ---- 0. stage the block's inputs\n"),
    (_SYNC + "\n  // ---- A.", _SYNC + "  mark(1);\n\n  // ---- A."),
    ("  __syncthreads();\n\n  // ---- B. the stages'",
     "  __syncthreads();\n  mark(2);\n\n  // ---- B. the stages'"),
    (_SYNC + "\n  // ---- B. the outputs",
     _SYNC + "  mark(3);\n\n  // ---- B. the outputs"),
    (_K2_END, _K2_END[:-2] + "  __syncthreads();\n  mark(4);\n}\n"),
    # K3: 0 start, 1 staged, 2 knot terms done, 4 end
    ("  extern __shared__ float sm[];\n",
     "  extern __shared__ float sm[];\n  mark(0);\n"),
    (_SYNC + "\n  // ---- one knot", _SYNC + "  mark(1);\n\n  // ---- one knot"),
    ("  __syncthreads();\n\n  // ---- one thread a row",
     "  __syncthreads();\n  mark(2);\n\n  // ---- one thread a row"),
    ("    vio_out[r0 + t] = vio;\n  }\n}\n",
     "    vio_out[r0 + t] = vio;\n  }\n  __syncthreads();\n  mark(4);\n}\n"),
]


def _copy(tag: str, edits, tail: str = "") -> str:
    """This tree's ``csrc/`` with ``edits`` made to assembly.cu (and
    ``tail`` appended), under build/probe_k23/``tag``."""
    out = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "probe_k23",
                       tag)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(SRC, out)
    path = os.path.join(out, "assembly.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"probe_k23 {tag}: {old!r} not in assembly.cu")
        src = src.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(src + tail)
    return out


def _shape_edits(scenarios: int, threads: int):
    assert_old = ('static_assert(MAX_SCENARIOS == 4, "block_scenario compares'
                  ' up to 3 n");')
    return [(f"constexpr int K2_THREADS = {AS_BUILT[1]};",
             f"constexpr int K2_THREADS = {threads};"),
            (f"constexpr int MAX_SCENARIOS = {AS_BUILT[0]};",
             f"constexpr int MAX_SCENARIOS = {scenarios};"),
            (assert_old, assert_old.replace("==", "<="))]


def _cases(dev):
    full = {PANDA.name: ck.inputs(PANDA, 1024, dev),
            HUSKY_PANDA.name: ck.inputs(HUSKY_PANDA, 4096, dev)}
    return [(PANDA, 1024, full[PANDA.name]),
            (HUSKY_PANDA, 4096, full[HUSKY_PANDA.name]),
            (HUSKY_PANDA, 1024, ck.first(full[HUSKY_PANDA.name], 1024))]


def _k2(case, sy):
    track, params, z, _, _, cu, rb = case
    return lambda: ak.build_qp_stages_k_kernel(track, z, rb, params, cu, TS,
                                               system=sy)


def variants(dev, reps: int) -> None:
    trees = {f"{AS_BUILT[0]} scenarios x {AS_BUILT[1]} threads (as built)":
             SRC}
    for s, t in SHAPES:
        trees[f"{s} x {t}"] = _copy(f"s{s}_t{t}", _shape_edits(s, t))
    names = list(trees)
    for name in names:
        cuda_build.use_sources(trees[name])
    for sy, batch, case in _cases(dev):
        fn = _k2(case, sy)
        cuda_build.use_sources(SRC)
        ref = fn()
        times = []
        for name in names + names[:1]:
            cuda_build.use_sources(trees[name])
            out = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(getattr(out, f), getattr(ref, f))
                       for f in ak._K2_OUT):
                raise AssertionError(f"K2 {name}: not bit-identical to the "
                                     "kernel as built")
            times.append((name, device_ms(fn, "assembly_kernel<", reps)))
        print(f"{sy.name} K2 at batch {batch}, device ms (all bit-identical): "
              + "; ".join(f"{n} {t:.4f}" for n, t in times))


def phases(dev) -> None:
    cuda_build.use_sources(_copy("phases", _PHASE_EDITS, _READ_CLOCKS))
    lib = cuda_build.library()
    lib.mpcc_probe_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mpcc_probe_clocks.restype = ctypes.c_int
    k2_names = ("staging", "phase A", "rows' staging", "phase B")
    k3_names = ("staging", "knot terms", "row sums")
    for sy, batch, case in _cases(dev):
        track, params, _, zt, zc, cu, rb = case
        k3 = lambda zz: lambda: ak.eval_point_kernel(track, zz, rb, params,
                                                     cu, TS, sy)
        for label, kernel, cand, fn, marks, names in (
                ("K2", 2, 1, _k2(case, sy), (0, 1, 2, 3, 4), k2_names),
                ("K3", 3, 1, k3(zt), (0, 1, 2, 4), k3_names),
                (f"K3 x{zc.shape[1]}", 3, zc.shape[1], k3(zc), (0, 1, 2, 4),
                 k3_names)):
            blocks = ak.launch_geometry(kernel, sy, sy.horizon, cand,
                                        batch)["blocks"]
            assert blocks <= MAX_BLOCKS
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            buf = np.zeros(MAX_BLOCKS * 5, dtype=np.uint64)
            cuda_build.check(lib.mpcc_probe_clocks(buf.ctypes.data, buf.size),
                             "probe clocks")
            t = buf[:blocks * 5].reshape(blocks, 5).astype(np.int64)
            med = [float(np.median(t[:, q] - t[:, p])) / 1e3
                   for p, q in zip(marks[:-1], marks[1:])]
            print(f"{sy.name} {label} at batch {batch}: {blocks} blocks, "
                  f"span {(t[:, 4].max() - t[:, 0].min()) / 1e3:.2f} us, "
                  f"latest start {(t[:, 0].max() - t[:, 0].min()) / 1e3:.2f}"
                  " us; per-block medians, us: "
                  + ", ".join(f"{n} {v:.2f}" for n, v in zip(names, med)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k23: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    both = not (args.variants or args.phases)
    if args.variants or both:
        variants(dev, args.reps)
    if args.phases or both:
        phases(dev)


if __name__ == "__main__":
    main()
