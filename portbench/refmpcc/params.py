"""Parameters as dataclasses of tensors, from a configuration's groups
(the keys of the reference's ``assets/params/*.json`` files; the port's
`params.py`).  :class:`SQPConfig` keeps the port's field names, so a
traffic file's ``sqp_config`` builds both sides' configurations; the
reference reads the fields that change the arithmetic (``rti``,
``max_iter``, ``qp_solver`` as Riccati or ``"admm"``, the IPM scheme and
warm start, SOC, BFGS, the line search, the ADMM budget) and computes
every kernel in its plain version, whatever route the other fields name.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import torch

from .system import PANDA, System


def _load_json(file) -> dict:
    """A parameter group: ``file`` itself where it is a dict already (a
    configuration's group), else the JSON file it names."""
    if isinstance(file, dict):
        return file
    with open(file, "r") as f:
        return json.load(f)


def _get(js: Mapping[str, Any], overrides: Mapping[str, float] | None, key: str):
    """Reference override-merge semantics: override map wins over JSON value."""
    if overrides is not None and key in overrides:
        return overrides[key]
    return js[key]


@dataclasses.dataclass
class ModelParams:
    """Projection / progress / constraint-tolerance parameters (model.json)."""

    max_dist_proj: torch.Tensor
    desired_ee_velocity: torch.Tensor
    s_trust_region: torch.Tensor
    deacc_ratio: torch.Tensor
    tol_sing: torch.Tensor
    tol_selcol: torch.Tensor
    tol_envcol: torch.Tensor


@dataclasses.dataclass
class CostParams:
    """MPCC cost weights (cost.json)."""

    q_c: torch.Tensor
    q_c_N_mult: torch.Tensor
    q_l: torch.Tensor
    q_vs: torch.Tensor
    q_ori: torch.Tensor
    q_sing: torch.Tensor
    r_dq: torch.Tensor
    r_ddq: torch.Tensor
    r_dVs: torch.Tensor
    q_c_red_ratio: torch.Tensor
    q_l_inc_ratio: torch.Tensor
    q_ori_red_ratio: torch.Tensor


@dataclasses.dataclass
class BoundsParams:
    """Box bounds on state, input, and joint acceleration (bounds.json)."""

    x_l: torch.Tensor    # (nx,)
    x_u: torch.Tensor
    u_l: torch.Tensor    # (nu,)
    u_u: torch.Tensor
    ddq_l: torch.Tensor  # (dof,)
    ddq_u: torch.Tensor


@dataclasses.dataclass
class NormalizationParams:
    """Diagonal state/input scalings T_x, T_u (normalization.json)."""

    t_x: torch.Tensor    # (nx,)
    t_u: torch.Tensor    # (nu,)

    @property
    def t_x_inv(self) -> torch.Tensor:
        return 1.0 / self.t_x

    @property
    def t_u_inv(self) -> torch.Tensor:
        return 1.0 / self.t_u


@dataclasses.dataclass
class SQPParams:
    """Runtime-tunable SQP scalars (sqp.json)."""

    eps_prim: torch.Tensor
    eps_dual: torch.Tensor
    line_search_tau: torch.Tensor
    line_search_eta: torch.Tensor
    line_search_rho: torch.Tensor


@dataclasses.dataclass
class MPCCParams:
    """All runtime-tunable parameters of one MPCC instance."""

    model: ModelParams
    cost: CostParams
    bounds: BoundsParams
    normalization: NormalizationParams
    sqp: SQPParams


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    """Static SQP structure (the port's fields and defaults: one
    warm-started RTI iteration on the Riccati route)."""

    max_iter: int = 1
    line_search_max_iter: int = 5
    rti: bool = True
    do_SOC: bool = False
    use_BFGS: bool = False
    qp_max_iter: int = 400
    qp_check_every: int = 25
    qp_warm_start: bool = True
    qp_backend: str = "xla"
    line_search: str = "filter"
    qp_solver: str = "riccati_pallas"
    ipm_max_iter: int = 25
    fleet_mode: bool = False
    nn_bf16: bool = False
    ipm_scheme: str = "adaptive"
    ipm_warm_start: bool = True
    ipm_warm_clip_lo: float = 0.1
    ipm_warm_clip_hi: float = 100.0
    mani_grad: str = "analytic"
    ipm_interpret: bool | None = None
    qp_assembly: str = "pallas"
    kin_backend: str = "pallas"


_X_KEYS = ["q1", "q2", "q3", "q4", "q5", "q6", "q7", "s", "vs"]
_U_KEYS = ["dq1", "dq2", "dq3", "dq4", "dq5", "dq6", "dq7", "dVs"]
_DDQ_KEYS = ["ddq1", "ddq2", "ddq3", "ddq4", "ddq5", "ddq6", "ddq7"]

# Mobile-base (Husky+Panda) keys, prepended for system.base_dof = 3; their
# values come from assets/params/mobile.json merged over the Panda files.
_XB_KEYS = ["xb", "yb", "thb"]
_UB_KEYS = ["dxb", "dyb", "dthb"]
_DDB_KEYS = ["ddxb", "ddyb", "ddthb"]


def _sys_keys(system: System):
    if system.base_dof == 0:
        return _X_KEYS, _U_KEYS, _DDQ_KEYS
    return _XB_KEYS + _X_KEYS, _UB_KEYS + _U_KEYS, _DDB_KEYS + _DDQ_KEYS


def _merge_mobile(js: dict, file: str, system: System) -> dict:
    """The mobile system's base keys (mobile.json beside ``file``) under
    the file's own keys."""
    if system.base_dof == 0 or isinstance(file, dict):
        return js
    mob = _load_json(os.path.join(os.path.dirname(file), "mobile.json"))
    return {**mob, **js}


def _tensor(v, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def load_model_params(file: str, overrides: Mapping[str, float] | None = None,
                      dtype=torch.float64, device="cuda") -> ModelParams:
    js = _load_json(file)
    g = lambda k: _tensor(_get(js, overrides, k), dtype, device)
    return ModelParams(
        max_dist_proj=g("max_dist_proj"),
        desired_ee_velocity=g("desired_ee_velocity"),
        s_trust_region=g("s_trust_region"),
        deacc_ratio=g("deaccelerate_ratio"),
        tol_sing=g("tol_sing"), tol_selcol=g("tol_selcol"),
        tol_envcol=g("tol_envcol"))


def load_cost_params(file: str, overrides: Mapping[str, float] | None = None,
                     dtype=torch.float64, device="cuda") -> CostParams:
    js = _load_json(file)
    g = lambda k: _tensor(_get(js, overrides, k), dtype, device)
    return CostParams(
        q_c=g("qC"), q_c_N_mult=g("qCNmult"), q_l=g("qL"), q_vs=g("qVs"),
        q_ori=g("qOri"), q_sing=g("qSing"),
        r_dq=g("rdq"), r_ddq=g("rddq"), r_dVs=g("rdVs"),
        q_c_red_ratio=g("qC_reduction_ratio"),
        q_l_inc_ratio=g("qL_increase_ratio"),
        q_ori_red_ratio=g("qOri_reduction_ratio"))


def load_bounds_params(file: str, overrides: Mapping[str, float] | None = None,
                       dtype=torch.float64, system: System = PANDA,
                       device="cuda") -> BoundsParams:
    js = _merge_mobile(_load_json(file), file, system)
    xk, uk, ddk = _sys_keys(system)
    vec = lambda keys, suffix: _tensor(
        [float(_get(js, overrides, k + suffix)) for k in keys], dtype, device)
    return BoundsParams(
        x_l=vec(xk, "l"), x_u=vec(xk, "u"), u_l=vec(uk, "l"),
        u_u=vec(uk, "u"), ddq_l=vec(ddk, "l"), ddq_u=vec(ddk, "u"))


def load_normalization_params(file: str,
                              overrides: Mapping[str, float] | None = None,
                              dtype=torch.float64, system: System = PANDA,
                              device="cuda") -> NormalizationParams:
    js = _merge_mobile(_load_json(file), file, system)
    xk, uk, _ = _sys_keys(system)
    vec = lambda keys: _tensor([float(_get(js, overrides, k)) for k in keys],
                               dtype, device)
    return NormalizationParams(t_x=vec(xk), t_u=vec(uk))


def load_sqp_params(file: str, overrides: Mapping[str, float] | None = None,
                    dtype=torch.float64,
                    device="cuda") -> tuple[SQPParams, SQPConfig]:
    """The sqp.json scalars and the structure keys (``max_iter``,
    ``line_search_max_iter``, ``do_SOC``, ``use_BFGS``) as an
    :class:`SQPConfig` with every other field at its default."""
    js = _load_json(file)
    g = lambda k: _get(js, overrides, k)
    t = lambda k: _tensor(g(k), dtype, device)
    sqp = SQPParams(
        eps_prim=t("eps_prim"), eps_dual=t("eps_dual"),
        line_search_tau=t("line_search_tau"),
        line_search_eta=t("line_search_eta"),
        line_search_rho=t("line_search_rho"))
    cfg = SQPConfig(max_iter=int(g("max_iter")),
                    line_search_max_iter=int(g("line_search_max_iter")),
                    do_SOC=bool(g("do_SOC")), use_BFGS=bool(g("use_BFGS")))
    return sqp, cfg


def params_from_groups(groups: Mapping[str, Mapping[str, Any]], dtype,
                       system: System = PANDA, device="cuda") -> MPCCParams:
    """:class:`MPCCParams` from a configuration's groups (``model``,
    ``cost``, ``bounds``, ``normalization``, ``sqp``: the keys of the
    reference's JSON files, the mobile keys merged in for the Husky+Panda)."""
    sqp, _ = load_sqp_params(dict(groups["sqp"]), None, dtype, device)
    return MPCCParams(
        model=load_model_params(dict(groups["model"]), None, dtype, device),
        cost=load_cost_params(dict(groups["cost"]), None, dtype, device),
        bounds=load_bounds_params(dict(groups["bounds"]), None, dtype, system,
                                  device),
        normalization=load_normalization_params(
            dict(groups["normalization"]), None, dtype, system, device),
        sqp=sqp)
