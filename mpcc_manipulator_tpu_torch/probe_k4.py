"""K4's code size, phases and variants, probed on one GPU.

    python -m mpcc_manipulator_tpu_torch.probe_k4 [--src DIR] [--sass]
        [--phases] [--variants]

``DIR`` holds the kernel sources to probe (this tree's ``csrc/`` by
default; for the kernel this tree's replaced -- the same per-thread code
storing straight to global memory -- the parent tree's ``csrc/`` unpacked
with ``git archive`` into a git-ignored directory).  On the first tick's
knots at the perturbed home states (``compare_k23.k4_inputs``: the Panda at
batch 1024, the Husky+Panda at 4096 and 1024):

* ``--sass``: the SASS instruction count of each ``kin_kernel``
  instantiation (``cuobjdump -sass`` on the built library) and ptxas's
  registers;
* ``--phases``: a copy whose thread 0 of each block reads ``clock64`` and
  the global timer at the phase boundaries (the replaced kernel: FK; the
  Jacobian columns and the composed outputs; A = J J' and the
  determinant; the damped Cholesky; the gradient; the dm stores.  This
  tree's: set-up; FK; the Jacobian columns and the staged outputs; A = J
  J'; the determinant and the Cholesky; the gradient; the stores); per
  launch the per-block median cycles of each phase and its share, and the
  span from the first block's start to the last block's end;
* ``--variants``: copies of the replaced kernel with (b) the gradient's
  ``j`` loop at ``#pragma unroll 1``, (c) one reciprocal per pivot and per
  diagonal in place of the divisions, (d) 64-thread blocks; of this
  tree's with 32 or 128 threads a block and with (c); each one's outputs'
  largest gap to the kernel as built and its device time, in turns (the
  kernel as built first and last).

With no flag, all three.  The copies are made from ``DIR`` by text edits
(each must find its text) into ``build/probe_k4/``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from . import compare_k23 as ck
from .ops import cuda_build
from .ops import kinematics_kernel as kk
from .system import HUSKY_PANDA, PANDA
from .timing import device_ms

MAX_BLOCKS = 16384
MARKS = 8

# thread 0 of each block stamps clock64 and the global timer at mark p;
# the value argument makes the stamp wait for the phase's last result
_CLOCKS = f'''
__device__ long long g_clk[{MAX_BLOCKS} * {MARKS}];
__device__ unsigned long long g_ns[{MAX_BLOCKS} * {MARKS}];
__device__ __forceinline__ void mark(int p, float v) {{
  if (threadIdx.x == 0) {{
    long long c;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) : "f"(v) : "memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "f"(v) : "memory");
    g_clk[blockIdx.x * {MARKS} + p] = c;
    g_ns[blockIdx.x * {MARKS} + p] = t;
  }}
}}
'''
_READ_CLOCKS = f'''
extern "C" int mpcc_probe_clocks(long long* clk, unsigned long long* ns,
                                 int n) {{
  cudaError_t err = cudaMemcpyFromSymbol(clk, g_clk, n * sizeof(long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyFromSymbol(
      ns, g_ns, n * sizeof(unsigned long long)));
}}
'''

# ---- the one-thread-a-configuration kernel
_OLD_HEAD = "template <int BASE_DOF>\n__global__ void kin_kernel("
_OLD_PHASES = (
    ["FK", "Jacobian columns + outputs", "A = J J' + determinant",
     "damped Cholesky", "gradient", "stores"],
    [(_OLD_HEAD, _CLOCKS + _OLD_HEAD),
     ("  if (t >= n) return;\n",
      "  if (t >= n) return;\n  mark(0, 0.f);\n"),
     ("  // ---- arm Jacobian columns",
      "  mark(1, r_ee[8] + p_ee[2]);\n  // ---- arm Jacobian columns"),
     ("  // ---- A = J J' (6x6)",
      "  mark(2, jvc[6][2]);\n  // ---- A = J J' (6x6)"),
     ("  // ---- damped Cholesky",
      "  mark(3, mani);\n  // ---- damped Cholesky"),
     ("  // ---- dm_i = m * sum_j",
      "  mark(4, l[5][5]);\n  // ---- dm_i = m * sum_j"),
     ("  float* dmo = dm_out",
      "  mark(5, dm[6]);\n  float* dmo = dm_out"),
     ("dmo[BASE_DOF + i] = mani * dm[i];\n}\n",
      "dmo[BASE_DOF + i] = mani * dm[i];\n  mark(6, 0.f);\n}\n")])
_OLD_VARIANTS = {
    "(b) gradient j loop at unroll 1": [
        ("#pragma unroll\n  for (int j = 0; j < ARM; ++j) {\n"
         "    float y[6], x[6];",
         "#pragma unroll 1\n  for (int j = 0; j < ARM; ++j) {\n"
         "    float y[6], x[6];")],
    "(c) reciprocals": [
        ("    const float safe = piv > 1e-30f ? piv : 1.f;\n",
         "    const float safe = piv > 1e-30f ? piv : 1.f;\n"
         "    const float rsafe = 1.f / safe;\n"),
        ("mm[a][b] -= mm[a][k] * mm[k][b] / safe;",
         "mm[a][b] -= mm[a][k] * mm[k][b] * rsafe;"),
        ("    const float dg = sqrtf(fmaxf(mm[k][k], floor_v));\n",
         "    const float dg = sqrtf(fmaxf(mm[k][k], floor_v));\n"
         "    const float rdg = 1.f / dg;\n"),
        ("l[a][k] = a >= k ? mm[a][k] / dg : 0.f;",
         "l[a][k] = a >= k ? mm[a][k] * rdg : 0.f;"),
        ("  float dm[ARM];\n",
         "  float rl[6];\n#pragma unroll\n"
         "  for (int a = 0; a < 6; ++a) rl[a] = 1.f / l[a][a];\n"
         "  float dm[ARM];\n"),
        ("      y[a] = acc / l[a][a];", "      y[a] = acc * rl[a];"),
        ("      x[a] = acc / l[a][a];", "      x[a] = acc * rl[a];")],
    "(d) 64-thread blocks": [
        ("  const int threads = 128;", "  const int threads = 64;")],
}

# ---- the staged design (this tree's: the same per-thread code, outputs
# staged in shared memory and stored coalesced)
_NEW_HEAD = "template <int BASE_DOF>\n__global__ void __launch_bounds__("
_NEW_PHASES = (
    ["set-up", "FK", "Jacobian columns + staged outputs", "A = J J'",
     "determinant + Cholesky", "gradient", "stores"],
    [(_NEW_HEAD, _CLOCKS + _NEW_HEAD)]
    + [(f"  // ---- {p}.", f"  mark({p}, 0.f);\n  // ---- {p}.")
       for p in range(7)]
    + [("  // ---- end.\n", "  mark(7, 0.f);\n")])
_NEW_VARIANTS = {
    **{f"{t} threads a block": [("constexpr int K4_THREADS = 64;",
                                 f"constexpr int K4_THREADS = {t};")]
       for t in (32, 128)},
    "(c) reciprocals": _OLD_VARIANTS["(c) reciprocals"]}


def _design(src_dir: str) -> str:
    with open(os.path.join(src_dir, "kinematics.cu")) as f:
        return "staged" if "// ---- 0." in f.read() else "thread"


def _copy(src_dir: str, tag: str, edits, tail: str = "") -> str:
    """``src_dir`` with ``edits`` made to kinematics.cu (and ``tail``
    appended), under build/probe_k4/``tag``."""
    out = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "probe_k4",
                       tag)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src_dir, out)
    path = os.path.join(out, "kinematics.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"probe_k4 {tag}: {old!r} not in "
                               "kinematics.cu")
        src = src.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(src + tail)
    return out


def _cases(dev):
    q = {PANDA.name: ck.k4_inputs(PANDA, 1024, dev)["main path"],
         HUSKY_PANDA.name: ck.k4_inputs(HUSKY_PANDA, 4096, dev)["main path"]}
    return [(PANDA, 1024, q[PANDA.name]),
            (HUSKY_PANDA, 4096, q[HUSKY_PANDA.name]),
            (HUSKY_PANDA, 1024, q[HUSKY_PANDA.name][:1024].contiguous())]


def _cuobjdump() -> str:
    nvcc = cuda_build._nvcc()
    cand = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def sass(src_dir: str) -> None:
    print("ptxas:\n" + cuda_build.use_sources(src_dir, ("kin_kernel",)))
    out = subprocess.run([_cuobjdump(), "-sass", cuda_build.library_path()],
                         capture_output=True, text=True, check=True).stdout
    name, counts = None, {}
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    for name, n in counts.items():
        if "kin_kernel" in name:
            print(f"SASS instructions, {name}: {n} ({16 * n} B of code)")


def phases(src_dir: str, dev) -> None:
    names, edits = (_NEW_PHASES if _design(src_dir) == "staged"
                    else _OLD_PHASES)
    cuda_build.use_sources(_copy(src_dir, "phases", edits, _READ_CLOCKS))
    lib = cuda_build.library()
    lib.mpcc_probe_clocks.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.mpcc_probe_clocks.restype = ctypes.c_int
    for sy, batch, q in _cases(dev):
        n = q.shape[0] * q.shape[1]
        blocks = (kk.launch_geometry(sy, n)["blocks"]
                  if _design(src_dir) == "staged" else -(-n // 128))
        assert blocks <= MAX_BLOCKS
        for _ in range(3):
            kk.kin_sweep(q, sy)
        torch.cuda.synchronize()
        clk = np.zeros(MAX_BLOCKS * MARKS, dtype=np.int64)
        ns = np.zeros(MAX_BLOCKS * MARKS, dtype=np.uint64)
        cuda_build.check(lib.mpcc_probe_clocks(
            clk.ctypes.data, ns.ctypes.data, clk.size), "probe clocks")
        m = len(names) + 1
        c = clk[:blocks * MARKS].reshape(blocks, MARKS)[:, :m]
        t = ns[:blocks * MARKS].reshape(blocks, MARKS)[:, :m].astype(np.int64)
        med = [float(np.median(c[:, p + 1] - c[:, p])) for p in range(m - 1)]
        total = float(np.median(c[:, m - 1] - c[:, 0]))
        print(f"{sy.name} K4 at batch {batch}: {blocks} blocks, span "
              f"{(t[:, m - 1].max() - t[:, 0].min()) / 1e3:.2f} us, latest "
              f"start {(t[:, 0].max() - t[:, 0].min()) / 1e3:.2f} us; "
              f"per-block median {total:.0f} cycles: "
              + ", ".join(f"{nm} {v:.0f} ({100 * v / total:.1f} %)"
                          for nm, v in zip(names, med)))


def variants(src_dir: str, dev, reps: int) -> None:
    edits_of = (_NEW_VARIANTS if _design(src_dir) == "staged"
                else _OLD_VARIANTS)
    trees = {"(a) as built": src_dir}
    for i, (name, edits) in enumerate(edits_of.items()):
        trees[name] = _copy(src_dir, f"v{i}", edits)
    for name, tree in trees.items():
        print(f"{name} ptxas:\n"
              + cuda_build.use_sources(tree, ("kin_kernel",)))
    names = list(trees)
    for sy, batch, q in _cases(dev):
        cuda_build.use_sources(src_dir)
        ref = kk.kin_sweep(q, sy)
        torch.cuda.synchronize()
        times, gaps = [], {}
        for name in names + names[:1]:
            cuda_build.use_sources(trees[name])
            out = kk.kin_sweep(q, sy)
            torch.cuda.synchronize()
            gaps[name] = max(ck.gap(r, o)[1] for r, o in zip(ref, out))
            times.append((name, device_ms(lambda: kk.kin_sweep(q, sy),
                                          "kin_kernel<", reps)))
        print(f"{sy.name} K4 at batch {batch}, device ms: "
              + "; ".join(f"{n} {t:.4f}" for n, t in times)
              + "; largest output gap to (a), of its scale: "
              + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=cuda_build._CSRC,
                    help="directory of the csrc/*.cu to probe")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k4: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.abspath(args.src)
    every = not (args.sass or args.phases or args.variants)
    if args.sass or every:
        sass(src)
    if args.phases or every:
        phases(src, dev)
    if args.variants or every:
        variants(src, dev, args.reps)


if __name__ == "__main__":
    main()
