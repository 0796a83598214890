"""K5, the fused ADMM loop (`csrc/admm.cu`, ``admm_kernel``): two launches
per SQP iteration on the dense ADMM route (the first check interval, then
the rest of the budget after the adaptive-rho point).

Bytes: K^-1, P, A, q, rho, the bounds, the Ruiz scalings and the warm
x / z / y in, x / z / y and the iteration count out, each once a launch,
float32.  Operations (`chip_smoke.py` ``k5_flops``): per iteration A'w,
rhs' K^-1 and A x (4mn + 2n^2) plus the elementwise updates; per test
x'P, y'A (2n^2 + 2mn) and the maxima, one test per 25 iterations and one
at each launch's entry; A x0 once a launch.  The iterations are the ones
the tick's outputs report (``MPCOutput.qp_iters``, summed over lanes).
"""

SYMBOL = "admm_kernel"


def work(sy, batch: int, launches: int, iters: float) -> tuple:
    n, m = sy.n_var, sy.n_constr
    floats = (2 * n * n + m * n + 3 * n + 6 * m + 1) + (n + 2 * m + 1)
    per_iter = 4 * m * n + 2 * n * n + 10 * m + 4 * n
    per_test = 2 * n * n + 2 * m * n + 10 * (m + n)
    flops = (iters * (per_iter + per_test / 25)
             + batch * launches * (per_test + 2 * m * n))
    return 4.0 * batch * launches * floats, flops
