"""K3, the line search's evaluation (`csrc/assembly.cu`, ``eval_kernel``):
one launch per SQP iteration on the Riccati route with the kernel
assembly, one candidate under the filter.

Bytes: the candidate iterate, the current input and the RobotData fields
K3 reads in, objective and violation out, each once, float32.
Operations: 1,500 float32 operations per knot and scenario
(`chip_smoke.py`'s count for K3's bound).
"""

SYMBOL = "eval_kernel"


def work(sy, batch: int, launches: int, iters: float) -> tuple:
    dof, nl, n, nu = sy.dof, sy.num_links, sy.horizon, sy.nu
    k = n + 1
    robot = k * (3 + 9 + 1 + dof + 1 + dof + nl + nl * dof) + 1
    floats = sy.n_var + nu + robot + 2
    return 4.0 * batch * launches * floats, 1.5e3 * k * batch * launches
