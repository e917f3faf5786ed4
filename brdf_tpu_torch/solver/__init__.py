"""Solvers: the levmar family (box, equality and inequality constrained LM,
the Ax=b suite, fit statistics), grid init, robust weights and the unfused
VarPro tiers. The exports are those of ``brdf_tpu/solver/__init__.py``."""

from brdf_tpu_torch.solver.lm import (  # noqa: F401
    LMOptions,
    LMResult,
    StopReason,
    fd_jacobian,
    check_jacobian,
    chkjac,
    levmar,
    levmar_bc,
    levmar_lec,
)
from brdf_tpu_torch.solver.axb import (  # noqa: F401
    ax_eq_b_chol,
    ax_eq_b_ldlt,
    ax_eq_b_lu,
    ax_eq_b_qr,
    ax_eq_b_qrls,
    ax_eq_b_svd,
    ldlt_bk,
)
from brdf_tpu_torch.solver.constrained import (  # noqa: F401
    levmar_blec,
    levmar_bleic,
    levmar_blic,
    levmar_leic,
    levmar_lic,
)
from brdf_tpu_torch.solver.varpro import (  # noqa: F401
    VarProResult,
    varpro_fit,
    varpro_fit_fresnel,
)
from brdf_tpu_torch.solver.varpro_joint import (  # noqa: F401
    JointVarProResult,
    varpro_fit_joint,
)
from brdf_tpu_torch.solver.stats import (  # noqa: F401
    corcoef,
    covariance,
    fit_statistics,
    r_squared,
    stddev,
)
