"""Parameter system: JSON files + override maps -> dataclasses of tensors
(`mpcc_manipulator_tpu/params.py`).

Each group loads from the same ``assets/params/*.json`` files as the JAX
package, and every key can be overridden through a ``{key: value}`` map
(the reference's ``ParamValue`` semantics).  Host-side setup is numpy /
plain Python; the result is a tree of scalar and vector tensors on the
requested device.

Solver structure lives in :class:`SQPConfig`, which keeps the JAX field
names.  Values the port does not run yet are rejected where they would be
used (`solver/sqp.py::check_supported`), never silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import torch

from .system import PANDA, System

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PARAM_DIR = os.path.join(_REPO_ROOT, "assets", "params")


def param_path(name: str, param_dir: str | None = None) -> str:
    """Resolve a parameter JSON file name inside the asset directory."""
    return os.path.join(param_dir or DEFAULT_PARAM_DIR, name)


def _load_json(file: str) -> dict:
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
    """Static SQP structure (field names of the JAX `SQPConfig`).

    The defaults are the JAX bench's configuration: real-time iteration
    (one warm-started SQP iteration per tick), the structured interior-point
    QP through the K1 kernel route with adaptive centering, the K4
    kinematics route (``kin_backend="pallas"``) with the analytic
    manipulability gradient, and the K2 assembly / K3 line-search route
    (``qp_assembly="pallas"``; ``"xla"`` selects the plain assembly and
    evaluation).  ``kin_backend="xla"`` is the plain kinematics route, with
    ``mani_grad`` ``"fd"`` (the reference's central difference), ``"ad"``
    (autodiff) or ``"analytic"``.  The converged mode is ``rti=False`` with
    ``max_iter`` up to 20 (the bench's ``MPCC_RTI=0``).
    ``qp_solver="admm"`` (with ``qp_assembly="xla"``) selects the dense
    ADMM path: ``qp_backend="pallas"`` runs the K5 route (its plain version
    for CPU tensors), ``"xla"`` the plain loop in the caller's dtype on any
    device; ``use_BFGS`` is an option of this path.  The JAX package's own
    default, which its ``api.MPCC`` runs, is :func:`reference_sqp_config`.
    """

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


# The JAX `SQPConfig()` where it differs from the bench configuration: the
# converged dense ADMM path with the plain loop, the plain kinematics with
# the finite-difference gradient, a cold interior point.
_REFERENCE_STRUCTURE = dict(rti=False, qp_solver="admm", qp_backend="xla",
                            qp_assembly="xla", kin_backend="xla",
                            mani_grad="fd", ipm_warm_start=False)


def reference_sqp_config(loaded: SQPConfig) -> SQPConfig:
    """The JAX package's default `SQPConfig`, which its ``api.MPCC`` runs,
    with the sqp.json keys (``max_iter``, ``line_search_max_iter``,
    ``do_SOC``, ``use_BFGS``) of ``loaded``, :func:`load_params`'s
    config."""
    return dataclasses.replace(loaded, **_REFERENCE_STRUCTURE)


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
    if system.base_dof == 0:
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
                       dtype=torch.float64, device="cuda",
                       system: System = PANDA) -> BoundsParams:
    js = _merge_mobile(_load_json(file), file, system)
    xk, uk, ddk = _sys_keys(system)
    vec = lambda keys, suffix: _tensor(
        [float(_get(js, overrides, k + suffix)) for k in keys], dtype, device)
    return BoundsParams(
        x_l=vec(xk, "l"), x_u=vec(xk, "u"), u_l=vec(uk, "l"),
        u_u=vec(uk, "u"), ddq_l=vec(ddk, "l"), ddq_u=vec(ddk, "u"))


def load_normalization_params(file: str,
                              overrides: Mapping[str, float] | None = None,
                              dtype=torch.float64, device="cuda",
                              system: System = PANDA) -> NormalizationParams:
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


def load_params(param_dir: str | None = None,
                overrides: Mapping[str, Mapping[str, float]] | None = None,
                dtype=torch.float64, device="cuda",
                system: System = PANDA) -> tuple[MPCCParams, SQPConfig]:
    """Load the full parameter set.

    ``overrides`` is a dict of groups (``param``, ``cost``, ``bounds``,
    ``normalization``, ``sqp``), each a ``{key: value}`` map merged over the
    JSON defaults.  The returned :class:`SQPConfig` carries the sqp.json
    structure keys (``max_iter``, ``line_search_max_iter``, ``do_SOC``,
    ``use_BFGS``); everything else keeps its default.
    """
    ov = overrides or {}
    path = lambda name: param_path(name, param_dir)
    sqp, cfg = load_sqp_params(path("sqp.json"), ov.get("sqp"), dtype, device)
    return MPCCParams(
        model=load_model_params(path("model.json"), ov.get("param"), dtype,
                                device),
        cost=load_cost_params(path("cost.json"), ov.get("cost"), dtype,
                              device),
        bounds=load_bounds_params(path("bounds.json"), ov.get("bounds"),
                                  dtype, device, system),
        normalization=load_normalization_params(
            path("normalization.json"), ov.get("normalization"), dtype,
            device, system),
        sqp=sqp), cfg
