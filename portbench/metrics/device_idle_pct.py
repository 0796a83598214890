"""device_idle_pct: the share of the traced window in which no operation
ran on the device, in %: 100 less the union of the profiler's device
events over the window's length."""


def read(ctx):
    if ctx["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
