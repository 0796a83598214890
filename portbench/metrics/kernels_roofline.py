"""kernels_roofline: the hand-written kernels' share of their roofline, in
%: the sum over the kernels that ran in the traced window of each one's
least time (the larger of its bytes over the peak memory rate and its
float32 operations over the peak float32 rate, from `kernels/*.py`'s work
counts) over the sum of their device time (`torch.profiler`'s events of
each kernel's symbol).  Nothing when no kernel ran."""


def read(ctx):
    ran = [k for k in ctx["kernels"].values() if k["launches"] > 0]
    device = sum(k["device_s"] for k in ran)
    if not ran or device <= 0.0:
        return None
    return 100.0 * sum(k["bound_s"] for k in ran) / device
