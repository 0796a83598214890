"""K2, the stage-QP assembly (`csrc/assembly.cu`, ``assembly_kernel``): one
launch per SQP iteration on the Riccati route with the kernel assembly.

Bytes: the iterate, the current input and the RobotData fields K2 reads in
(every knot), the StageQPK blocks it writes out, each once, float32 (the
small shared table of track and cost scalars is left out).  Operations:
3,000 float32 operations per knot and scenario (`chip_smoke.py`'s count
for K2's bound).
"""

SYMBOL = "assembly_kernel"


def work(sy, batch: int, launches: int, iters: float) -> tuple:
    nx, nu, dof, npc, nl, n = (sy.nx, sy.nu, sy.dof, sy.npc, sy.num_links,
                               sy.horizon)
    k = n + 1
    robot = k * (3 + 9 + 6 * dof + 1 + dof + 1 + dof + nl + nl * dof) + 1
    floats_in = sy.n_var + nu + robot
    floats_out = (k * nx * nx + n * nu * nu + k * nx + n * nu + n * dof
                  + n * nx + 2 * n * nx + 2 * n * nu + 2 * n * dof + n * npc
                  + n * npc * nx + n * npc * nu)
    return (4.0 * batch * launches * (floats_in + floats_out),
            3e3 * k * batch * launches)
