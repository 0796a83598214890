"""admm_iters: ADMM iterations per lane-tick on the dense route (K5,
`solver/qp_admm.py`), the mean of ``MPCOutput.qp_iters`` over the traced
window's lane-ticks."""


def read(ctx):
    return ctx["qp_iters_mean"] if ctx["route"] == "admm" else None
