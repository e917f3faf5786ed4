"""Solvers: grid init, robust weights, the unfused VarPro tiers, the eager LM."""

from brdf_tpu_torch.solver.lm import (  # noqa: F401
    LMOptions,
    LMResult,
    StopReason,
    check_jacobian,
    fd_jacobian,
    levmar,
    levmar_bc,
    levmar_lec,
)
from brdf_tpu_torch.solver.varpro import (  # noqa: F401
    VarProResult,
    varpro_fit,
    varpro_fit_fresnel,
)
from brdf_tpu_torch.solver.varpro_joint import JointVarProResult, varpro_fit_joint  # noqa: F401
