"""K4, the kinematic half of RobotData (`csrc/kinematics.cu`,
``kin_kernel``): one launch per tick over every knot's configuration.

Bytes: the configurations in, EE position and rotation, the Jacobians, the
manipulability and its gradient out, each once, float32.  Operations: the
float32 operations of one configuration counted from the kernel's loops
(`chip_smoke.py` ``k4_flops``: a multiply-add counts 2, a division, square
root, sine or cosine 1), arm and, for the mobile base, its composition.
"""

SYMBOL = "kin_kernel"


def _flops(dof: int) -> int:
    arm = 7
    trail = sum((5 - k) ** 2 for k in range(6))
    fk = arm * (2 + 3 * 5 + 9 * 5 + 3 + 3 * 6)
    ee = 3 * 6 + 9 * 5 + 3 * arm + 9 * arm
    gram = 36 * 2 * arm
    det = 6 + 3 * trail + 1
    chol = 8 + 1 + 7 + 6 + 21 + 2 * trail
    solves = arm * 2 * (2 * 15 + 6)
    pairs_lt, pairs_ge = arm * (arm - 1) // 2, arm * (arm + 1) // 2
    grad = (pairs_lt * (4 * 9 + 3 + 11) + pairs_ge * (9 + 5) + arm * arm
            + arm)
    base = 0 if dof == arm else 8 + 3 * 6 + 1 + 2 * arm * 6
    return fk + ee + gram + det + chol + solves + grad + base


def work(sy, batch: int, launches: int, iters: float) -> tuple:
    dof = sy.dof
    configs = batch * (sy.horizon + 1) * launches
    floats = dof + 3 + 9 + 6 * dof + 1 + dof
    return 4.0 * configs * floats, float(_flops(dof)) * configs
