"""`mpc_step` at N = 5 and N = 20 against the JAX package, both systems,
float64 on the CPU: the bench configuration (RTI, plain versions on the
CPU) tick for tick against JAX `mpc_step` (its plain path of the same
algorithm, tests/test_torch_mpc.py's ``JAX_CFG``), 2 lanes x 6 ticks: ok,
status and IPM iterations equal, states within 1e-8.  One JAX compile per
(system, N); the parts of the tick are held in tests/test_torch_horizon.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcc_manipulator_tpu.models import dynamics as jdyn
from mpcc_manipulator_tpu.mpc import init_carry as j_init_carry
from mpcc_manipulator_tpu.mpc import mpc_step as jax_mpc_step
from mpcc_manipulator_tpu_torch.models.dynamics import sim_time_step
from mpcc_manipulator_tpu_torch.mpc import init_carry, mpc_step
from mpcc_manipulator_tpu_torch.params import SQPConfig
from tests.test_torch_horizon import CASES, IDS, _home, _systems, problems
from tests.test_torch_mpc import JAX_CFG

torch.set_num_threads(1)

TS = 0.01
LANES = 2
TICKS = 6
# float64 closed loop: the two implementations differ only in summation
# order, so states agree to roundoff amplified over the ticks
STATE_TOL = 1e-8


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rti_mpc_step_matches_jax(problems, case):
    """Per tick: ok, status and IPM iterations equal, states within 1e-8;
    the horizon has N + 1 knots, and s advances."""
    sy, jsy = _systems(*case)
    n = case[1]
    (jtrack, jp, jsel, jenv, obs), (track, params, sel, env) = \
        problems[case[0]]
    step = jax.jit(lambda c, x, u: jax_mpc_step(
        jtrack, jp, jsel, jenv, c, x, u, obs, jnp.asarray(0.0, jnp.float64),
        ts=TS, cfg=JAX_CFG, system=jsy))
    rng = np.random.default_rng(5)
    x0 = _home(sy)[None] + 0.01 * rng.standard_normal((LANES, sy.nx))
    x0[:, sy.s_idx:] = np.abs(x0[:, sy.s_idx:])
    carries = [j_init_carry(jnp.float64, jsy)] * LANES
    xj = [jnp.asarray(x0[i]) for i in range(LANES)]
    uj = [jnp.zeros(sy.nu, jnp.float64)] * LANES
    dt = torch.float64
    carry = init_carry(LANES, dt, "cpu", sy)
    x = torch.tensor(x0)
    u = torch.zeros(LANES, sy.nu, dtype=dt)
    obs_t = torch.tensor(np.asarray(obs)).expand(LANES, 3)
    rad = torch.zeros(LANES, dtype=dt)
    for t in range(TICKS):
        carry, out = mpc_step(track, params, sel, env, carry, x, u, obs_t,
                              rad, ts=TS, cfg=SQPConfig(), system=sy)
        u = out.u0
        x = sim_time_step(out.x0_updated, u, TS)
        if t == 0:
            x_first = x.clone()
        for i in range(LANES):
            carries[i], oj = step(carries[i], xj[i], uj[i])
            uj[i] = oj.u0
            xj[i] = jdyn.sim_time_step(oj.x0_updated, oj.u0, TS)
            assert bool(out.ok[i]) == bool(oj.ok), (t, i)
            assert int(out.status[i]) == int(oj.status), (t, i)
            assert int(out.qp_iters[i]) == int(oj.qp_iters), (t, i)
        gap = float(np.abs(x.numpy() - np.stack(xj)).max())
        assert gap < STATE_TOL, (t, gap)
    assert bool(out.ok.all())
    assert out.horizon_x.shape == (LANES, n + 1, sy.nx)
    assert out.horizon_u.shape == (LANES, n, sy.nu)
    assert carry.ipm_s.shape == (LANES, n + 1, sy.nc_stage)
    # s advances once the first tick's projection has placed it
    assert bool((x[:, sy.s_idx] > x_first[:, sy.s_idx]).all())
