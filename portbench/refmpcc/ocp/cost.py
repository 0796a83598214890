"""MPCC stage cost: value, gradient, Gauss-Newton Hessian, batched over
leading (scenario, knot) axes (`mpcc_manipulator_tpu/ocp/cost.py`).

The derivatives are written out as in the reference's model, including its
omissions (frozen RobotData, non-differentiated velocity taper, and the
reference's right-Jacobian-inverse variant by default).  One deliberate
deviation is kept from the JAX package: the lag-error derivative uses the
signed tangential error ``t.e`` where the reference uses ``||e_lag||``,
whose sign is wrong when the EE is behind the reference point.
"""

from __future__ import annotations

import torch

from ..params import MPCCParams
from ..splines import arc_length as als
from ..splines.arc_length import TrackSpline
from ..system import PANDA, System
from ..utils import so3
from .robot_data import RobotData


def _dot(a, b):
    return (a * b).sum(-1)


def _cubic_blend(x, x0, xf, y0, yf):
    """Smoothstep from (x0, y0) to (xf, yf), unclamped like the reference."""
    t = (x - x0) / (xf - x0)
    return y0 + (yf - y0) * (3.0 * t * t - 2.0 * t * t * t)


def scheduled_weights(params: MPCCParams, rb: RobotData):
    """Proximity-triggered weight scheduling."""
    ratio = torch.minimum(rb.sel_dist / (params.model.tol_selcol * 2.0),
                          rb.manipul / (params.model.tol_sing * 2.0))
    c = params.cost
    near = ratio <= 1.0
    q_c = torch.where(near, c.q_c * _cubic_blend(ratio, 0.5, 1.0,
                                                 c.q_c_red_ratio, 1.0), c.q_c)
    q_l = torch.where(near, c.q_l * _cubic_blend(ratio, 0.5, 1.0,
                                                 c.q_l_inc_ratio, 1.0), c.q_l)
    q_ori = torch.where(near, c.q_ori * _cubic_blend(
        ratio, 0.5, 1.0, c.q_ori_red_ratio, 1.0), c.q_ori)
    return q_c, q_l, q_ori


def error_info(track: TrackSpline, x: torch.Tensor, rb: RobotData,
               system: System = PANDA):
    """Contouring/lag error decomposition + state Jacobians."""
    s = x[..., system.s_idx]
    p_ref = als.track_position(track, s)
    tangent = als.track_derivative(track, s)
    normal = als.track_second_derivative(track, s)
    total_err = rb.ee_pos - p_ref
    t_e = _dot(tangent, total_err)
    lag_err = t_e[..., None] * tangent
    cont_err = total_err - lag_err

    d_total = x.new_zeros(x.shape[:-1] + (3, system.nx))
    d_total[..., :system.dof] = rb.jv
    d_total[..., system.s_idx] = -tangent
    d_tangent = x.new_zeros(x.shape[:-1] + (3, system.nx))
    d_tangent[..., system.s_idx] = normal

    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    d_lag = (tangent[..., :, None] * tangent[..., None, :]) @ d_total + (
        tangent[..., :, None] * total_err[..., None, :]
        + t_e[..., None, None] * eye) @ d_tangent
    d_cont = d_total - d_lag
    return cont_err, lag_err, d_cont, d_lag, tangent, normal


def desired_velocity(params: MPCCParams, s, s_max):
    """Desired path speed with terminal taper."""
    m = params.model
    taper = -m.desired_ee_velocity / (s_max * m.deacc_ratio) * (s - s_max)
    return torch.where(s < s_max * m.deacc_ratio, m.desired_ee_velocity,
                       taper)


def stage_cost(track: TrackSpline, x: torch.Tensor, u: torch.Tensor,
               rb: RobotData, is_terminal: torch.Tensor, params: MPCCParams,
               exact_heading_jac: bool = False, with_derivatives: bool = True,
               system: System = PANDA):
    """Full stage cost at every knot of x (..., nx), u (..., nu).

    Returns ``obj`` if ``with_derivatives`` is False, else
    ``(obj, f_x, f_u, f_xx, f_uu, f_xu)``.
    """
    q_c, q_l, q_ori = scheduled_weights(params, rb)
    c = params.cost
    s = x[..., system.s_idx]

    cont_err, lag_err, d_cont, d_lag, _, _ = error_info(track, x, rb, system)
    qc_k = torch.where(is_terminal, c.q_c_N_mult * q_c, q_c)
    dv = x[..., system.vs_idx] - desired_velocity(params, s, track.length)
    obj_cont = (qc_k * _dot(cont_err, cont_err)
                + q_l * _dot(lag_err, lag_err) + c.q_vs * dv * dv)

    r_ref = als.track_orientation(track, s)
    dr_ref = als.track_orientation_derivative(track, s)
    r_cur = rb.ee_rot
    log_rbar = so3.log_rot_vec(r_ref.transpose(-1, -2) @ r_cur)
    obj_head = q_ori * _dot(log_rbar, log_rbar)

    dq = u[..., :system.dof]
    u_dvs = u[..., system.dvs_idx]
    obj_input = torch.where(is_terminal, torch.zeros_like(u_dvs),
                            c.r_dq * _dot(dq, dq) + c.r_dVs * u_dvs ** 2)
    obj = obj_cont + obj_head + obj_input - c.q_sing * rb.manipul
    if not with_derivatives:
        return obj

    tT = lambda m: m.transpose(-1, -2)
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    f_x = (mv(2.0 * qc_k[..., None, None] * tT(d_cont), cont_err)
           + mv(2.0 * q_l[..., None, None] * tT(d_lag), lag_err))
    f_x[..., system.vs_idx] += 2.0 * c.q_vs * dv

    jr_inv = (so3.right_jacobian_inverse(log_rbar) if exact_heading_jac
              else so3.right_jacobian_inverse_ref(log_rbar))
    jr_rt = jr_inv @ tT(r_cur)
    d_log = x.new_zeros(x.shape[:-1] + (3, system.nx))
    d_log[..., :system.dof] = jr_rt @ rb.jw
    d_log[..., system.s_idx] = -mv(jr_rt, dr_ref)
    f_x = f_x + mv(2.0 * q_ori[..., None, None] * tT(d_log), log_rbar)
    f_x[..., :system.dof] += -c.q_sing * rb.d_manipul

    not_term = torch.where(is_terminal, 0.0, 1.0).to(x.dtype)
    f_u = x.new_zeros(x.shape[:-1] + (system.nu,))
    f_u[..., :system.dof] = not_term[..., None] * 2.0 * c.r_dq * dq
    f_u[..., system.dvs_idx] = not_term * 2.0 * c.r_dVs * u_dvs

    f_xx = (2.0 * qc_k[..., None, None] * tT(d_cont) @ d_cont
            + 2.0 * q_l[..., None, None] * tT(d_lag) @ d_lag
            + 2.0 * q_ori[..., None, None] * tT(d_log) @ d_log)
    f_xx[..., system.vs_idx, system.vs_idx] += 2.0 * c.q_vs

    f_uu = x.new_zeros(x.shape[:-1] + (system.nu, system.nu))
    ar = torch.arange(system.dof, device=x.device)
    f_uu[..., ar, ar] = (not_term * 2.0 * c.r_dq)[..., None]
    f_uu[..., system.dvs_idx, system.dvs_idx] = not_term * 2.0 * c.r_dVs
    f_xu = x.new_zeros(x.shape[:-1] + (system.nx, system.nu))

    # Tikhonov regularization
    f_xx = f_xx + 1e-6 * torch.eye(system.nx, dtype=x.dtype, device=x.device)
    f_uu = f_uu + 1e-6 * torch.eye(system.nu, dtype=x.dtype, device=x.device)
    return obj, f_x, f_u, f_xx, f_uu, f_xu
