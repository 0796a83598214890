"""Timing on the card: a wrapper's time (CUDA events), a kernel's own
device time (``torch.profiler``'s device events of its symbol) and a
wrapper's host time per call."""

from __future__ import annotations

import time

import torch

# profiler windows device_ms takes at most (one window recorded none of
# 50 launches of K4, a kernel of about 10 us)
PROFILE_TRIES = 3


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, symbol: str, reps: int) -> float:
    """Mean device milliseconds of one launch of the kernel whose name holds
    ``symbol``: ``torch.profiler``'s device events of that kernel over
    ``reps`` calls of ``fn`` (each call launches it once), after one
    warm-up call.  The wrapper's host work and any other kernel it launches
    are not counted.  The profiler may miss launches made right after it
    starts, so the mean is over the launches it recorded, and a window
    where it recorded fewer than half is taken again (at most
    ``PROFILE_TRIES`` windows); raises when every window recorded fewer
    than half, or one recorded more than one a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [getattr(e, "device_time_total", None) or e.cuda_time_total
              for e in prof.events()
              if e.device_type == DeviceType.CUDA and symbol in e.name]
        if len(us) > reps:
            break
        if len(us) >= reps / 2:
            return sum(us) / len(us) / 1e3
    raise AssertionError(f"device time of {symbol}: the profiler shows "
                         f"{len(us)} launches for {reps} calls")


def host_us(fn, reps: int = 20) -> float:
    """The host microseconds per call of ``fn``: the host clock around
    ``reps`` calls with no synchronize (the launches queue up behind it),
    then one synchronize outside the timed span.  Few calls, so that the
    launch queue does not fill and hold the host back to the device's
    pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6
