"""K1, the interior-point QP solve (`csrc/qp_ipm.cu`, ``ipm_kernel``): one
launch per SQP iteration on the Riccati route.

Bytes: every StageQPK block and the warm slack / dual rows in, the step,
duals, slacks and verdicts out, each once, float32.  Operations: the
adaptive scheme's float32 operations per Newton iteration (`chip_smoke.py`
``k1_flops``, counted from the kernel's loops at the Panda's dims and
scaled with each term's sizes), times the Newton iterations the tick's
outputs report (``MPCOutput.qp_iters``, summed over lanes).
"""

SYMBOL = "ipm_kernel"


def work(sy, batch: int, launches: int, iters: float) -> tuple:
    nx, nu, dof, npc, nc, n = (sy.nx, sy.nu, sy.dof, sy.npc, sy.nc_stage,
                               sy.horizon)
    nxt = nx + nu
    floats_in = ((n + 1) * nx * nx + n * nu * nx + n * nu * nu + n * dof
                 + (n + 1) * nx + n * nu + n * dof + n * nx + nx * nu + 1
                 + nx + nu + dof + n * (2 * nx + 2 * nu + 2 * dof + npc)
                 + n * npc * nx + n * npc * nu + 2 * n * nc)
    floats_out = (n + 1) * nxt + n * nu + 2 * n * nc + 3
    nbytes = 4.0 * batch * launches * (floats_in + floats_out)
    entries = nx * (nx + 1) // 2 + nu * nx + nu * (nu + 1) // 2 + dof
    per_iter = 2e5 * (50 * entries / 160 + 136 * nxt * nxt * nu / 2312
                      + 30 * nc / 59) / 216
    return nbytes, per_iter * iters
