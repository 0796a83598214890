"""The traced run's readings: phase spans, host syncs, and the device trace.

* :func:`span_timer`: the program's own `solver/sqp_debug.PhaseTimer`
  (CUDA event pairs per phase, read after the window) that also opens a
  host span (``torch.profiler.record_function``) around each phase, so the
  trace can name what the host was doing while the device sat idle;
* :func:`count_syncs`: the device-to-host syncs a call makes, from
  ``torch.cuda.set_sync_debug_mode("warn")``'s warnings (the method of
  `chip_smoke.sync_sites`);
* :func:`device_reading`: from a device-only profile of the traced
  window, the union of device activity (busy seconds), the ops with the
  most device time, each kernel's device seconds and launches;
* :func:`idle_gaps`: from a host-and-device profile, the device's idle
  gaps named by the innermost host span open at their middle.
"""

from __future__ import annotations

import contextlib
import re
import traceback
import warnings

import torch

HOST_SPANS = ("set_env", "set_qp", "solve_qp", "get_alpha", "plant",
              "record", "mpc_step")  # the program's phases, then the harness's
WINDOW = "portbench_window"


def span(name: str):
    return torch.profiler.record_function(name)


def span_timer(device):
    """A `PhaseTimer` of the program whose phases are host spans too."""
    from mpcc_manipulator_tpu_torch.solver.sqp_debug import PhaseTimer

    class SpanTimer(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name: str):
            with span(name), super().phase(name):
                yield

    return SpanTimer(device)


def count_syncs(fn, package: str, device) -> list:
    """The device-to-host syncs ``fn()`` makes, each as ``file:line`` of the
    innermost frame of ``package`` that asked for it (none off a card,
    where ``fn`` just runs)."""
    sites = []
    if device.type != "cuda":
        fn()
        return sites

    def record(message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if f"/{package}/" in f.filename]
        top = frames[-1] if frames else stack[-1]
        where = top.filename.split(f"/{package}/")[-1] if frames else \
            f"outside {package}: {top.filename}"
        sites.append(f"{where}:{top.lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def _strip(s: str) -> tuple:
    """``(name, top-level template arguments)`` of a C++ symbol, without
    its parameter list."""
    depth, name, args, cur = 0, [], [], []
    for ch in s:
        if ch in "<(":
            depth += 1
            if depth == 1 and ch == "(":
                break
            if depth == 1:
                continue
        elif ch in ">)":
            depth -= 1
            if depth == 0:
                args.append("".join(cur))
                cur = []
                continue
        if depth == 0:
            name.append(ch)
        elif depth == 1 and ch == ",":
            args.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    return "".join(name), [a.strip() for a in args if a.strip()]


def _base(s: str) -> str:
    return _strip(s)[0].strip().split("::")[-1].strip()


def clean_name(name: str) -> str:
    """A device op's name without ``void``, namespaces, template arguments
    or parameter list, and the first template argument that names a type
    where one does: ``void (anonymous namespace)::ipm_kernel<0>(...)`` reads
    ``ipm_kernel``, ``void at::native::vectorized_elementwise_kernel<4,
    at::native::CUDAFunctor_add<float>, ...>(...)`` reads
    ``vectorized_elementwise_kernel[CUDAFunctor_add]``."""
    s = name.strip().replace("(anonymous namespace)", "anonymous")
    if s.startswith("void "):
        s = s[5:]
    base, args = _strip(s)
    base = base.strip().split("::")[-1].strip()
    typed = [_base(a) for a in args if not re.fullmatch(r"[-0-9a-fx.ul]+", a)]
    typed = [t for t in typed if t]
    out = f"{base}[{typed[0]}]" if typed else base
    return re.sub(r"\s+", "_", out)[:64] or name[:64]


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _device_events(events) -> list:
    """``(start, end, name)`` in us of the device's operations (kernels,
    copies, sets), without the spans' ranges on the device timeline."""
    from torch.autograd import DeviceType
    annotations = set(HOST_SPANS) | {WINDOW}
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in annotations]


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def device_reading(prof, kernel_symbols: dict) -> dict:
    """From a device-only ``torch.profiler.profile`` of the traced window
    (nothing else on the device while it ran): the busy seconds (the union
    of the device's operations), the ten operations with the most device
    time, and each kernel's device seconds and launches."""
    device = _device_events(prof.events())
    busy = _union([(a, b) for a, b, _ in device])
    ops: dict = {}
    kernels = {k: [0.0, 0] for k in kernel_symbols}
    for a, b, name in device:
        key = clean_name(name)
        ops[key] = ops.get(key, 0.0) + (b - a) * 1e-6
        for k, symbol in kernel_symbols.items():
            if symbol in name:
                kernels[k][0] += (b - a) * 1e-6
                kernels[k][1] += 1
    return dict(busy_s=sum(b - a for a, b in busy) * 1e-6,
                device_ops=_top(ops),
                kernels={k: {"device_s": v[0], "launches": v[1]}
                         for k, v in kernels.items()})


def idle_gaps(prof) -> list:
    """From a host-and-device profile whose ticks ran inside the
    :data:`WINDOW` span: the device's idle gaps, each named by the
    innermost host span open at its middle, seconds summed by name."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    window = [e for e in events if e.name == WINDOW and e.device_type == cpu]
    if not window:
        raise RuntimeError("the gap segment's window span is missing")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.name in HOST_SPANS and e.device_type == cpu]
    busy = _union([(max(a, w0), min(b, w1))
                   for a, b, _ in _device_events(events)
                   if min(b, w1) > max(a, w0)])
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_spans = [(e - s, n) for s, e, n in host if s <= mid <= e]
        name = min(open_spans)[1] if open_spans else "between_spans"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return _top(gaps)
