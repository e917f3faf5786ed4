"""Levenberg-Marquardt option, result and stop-code types.

Port of the types of ``brdf_tpu/solver/lm.py`` that the fit pipeline
returns. The solver itself (``levmar_bc``) comes with the LM slice
(ROADMAP.md Queue A item 4).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch


class StopReason(enum.IntEnum):
    """Termination codes, aligned with levmar ``info[6]``."""

    RUNNING = 0
    SMALL_GRADIENT = 1
    SMALL_DP = 2
    MAX_ITERATIONS = 3
    SINGULAR = 4
    NO_REDUCTION = 5
    SMALL_CHI2 = 6
    INVALID_VALUES = 7


class LMOptions(NamedTuple):
    """Solver controls, with the JAX package's defaults. The VarPro engine
    reads only ``itmax`` (its Newton step count is ``min(itmax, 16)``)."""

    tau: float = 1e-3
    eps1: float = 1e-15
    eps2: float = 1e-15
    eps3: float = 1e-20
    itmax: int = 100
    max_inner: int = 24
    mu_max: float = 1e32
    axis_name: str | None = None
    linsolver: str = "cholesky"
    damping: str = "add"


class LMResult(NamedTuple):
    p: torch.Tensor          # (..., m) fitted parameters
    chi2: torch.Tensor       # (...,) final ||e||²
    chi2_init: torch.Tensor  # (...,) initial ||e||²
    g_inf: torch.Tensor      # (...,) final projected-gradient inf-norm
    iters: torch.Tensor      # (...,) outer iterations (accepted VarPro steps)
    stop: torch.Tensor       # (...,) StopReason
    nfev: torch.Tensor       # (...,) residual evaluations
    njev: torch.Tensor       # (...,) Jacobian evaluations
    mu: torch.Tensor         # (...,) final damping μ — resume state
    nu: torch.Tensor         # (...,) final ν — resume state
    nlss: torch.Tensor       # (...,) linear systems solved
    constraint_violation: torch.Tensor

    def warm_state(self):
        """(μ, ν, stop) for resuming: lanes stopped at MAX_ITERATIONS are
        reopened (cut off, not converged); other stop codes are final."""
        stop = torch.where(
            self.stop == int(StopReason.MAX_ITERATIONS),
            torch.full_like(self.stop, int(StopReason.RUNNING)),
            self.stop,
        )
        return self.mu, self.nu, stop
