"""ipm_iters: interior-point Newton iterations per lane-tick on the Riccati
route (K1, `solver/qp_ipm_kernel.py`), the mean of ``MPCOutput.qp_iters``
over the traced window's lane-ticks."""


def read(ctx):
    return ctx["qp_iters_mean"] if ctx["route"] == "riccati" else None
