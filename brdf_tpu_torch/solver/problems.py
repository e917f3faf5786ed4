"""Golden nonlinear-least-squares problems for solver verification.

Port of ``brdf_tpu/solver/problems.py``: the same problems, with residuals
in PyTorch (the expfit problem's data as float64 tensors).

The reference validates its solver family through ``levmar/lmdemo.c`` — 21
classic NLS problems with known minimizers (SURVEY.md §4). This module carries
the same *pattern*: canonical problems (standard public formulations from the
Moré-Garbow-Hillstrom and Hock-Schittkowski collections), each with its known
minimum, used as pytest golden cases for :mod:`brdf_tpu_torch.solver.lm`.

Each problem is a :class:`Problem` with a residual function ``r(p, data)``
whose squared norm the solver minimizes.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class Problem(NamedTuple):
    name: str
    residual: Callable
    p0: tuple[float, ...]
    p_star: tuple[float, ...]       # known minimizer
    lower: tuple[float, ...] | None = None
    upper: tuple[float, ...] | None = None
    data: object = None
    # linear equality constraint A p = b (levmar_lec problems)
    A: np.ndarray | None = None
    b: np.ndarray | None = None
    # linear inequality constraint C p ≥ d (levmar_bleic problems)
    C: np.ndarray | None = None
    d: np.ndarray | None = None
    penalty_weight: float | None = None   # blec box-penalty weight override
    tol: float = 1e-5
    itmax: int = 300


def _rosenbrock(p, data=None):
    return torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])


def _powell(p, data=None):
    return torch.stack([p[0], 10.0 * p[0] / (p[0] + 0.1) + 2.0 * p[1] ** 2])


def _wood(p, data=None):
    s = math.sqrt(10.0)
    return torch.stack(
        [
            10.0 * (p[1] - p[0] ** 2),
            1.0 - p[0],
            math.sqrt(90.0) * (p[3] - p[2] ** 2),
            1.0 - p[2],
            s * (p[1] + p[3] - 2.0),
            (p[1] - p[3]) / s,
        ]
    )


def _helical_valley(p, data=None):
    theta = torch.atan2(p[1], p[0]) / (2.0 * math.pi)
    return torch.stack(
        [
            10.0 * (p[2] - 10.0 * theta),
            10.0 * (torch.sqrt(p[0] ** 2 + p[1] ** 2) - 1.0),
            p[2],
        ]
    )


# Meyer's data-fitting problem (scaled form): x ≈ p0 · exp(10 p1/(u + p2) − 13)
_MEYER_X = np.array(
    [34.780, 28.610, 23.650, 19.630, 16.370, 13.720, 11.540, 9.744,
     8.261, 7.030, 6.005, 5.147, 4.427, 3.820, 3.307, 2.872]
)
_MEYER_U = 0.45 + 0.05 * np.arange(1, 17)


def _meyer(p, data=None):
    u = torch.as_tensor(_MEYER_U).to(p)
    x = torch.as_tensor(_MEYER_X).to(p)
    return p[0] * torch.exp(10.0 * p[1] / (u + p[2]) - 13.0) - x


def _quad_target(p, data=None):
    """Separable quadratic with minimum at (2, 3) — becomes an active-bound
    problem under the box [.,1]×[.,1]."""
    return torch.stack([p[0] - 2.0, p[1] - 3.0])


def _hs28_residual(p, data=None):
    return torch.stack([p[0] + p[1], p[1] + p[2]])


def _exponential_fit(p, data):
    """expfit.c-style synthetic data fit: y = p0·exp(−p1 t) + p2."""
    t, y = data
    return p[0] * torch.exp(-p[1] * t) + p[2] - y


def _modified_rosenbrock(p, data=None):
    """Modified Rosenbrock (MGH): extra constant residual."""
    return torch.stack(
        [10.0 * (p[1] - p[0] ** 2), 1.0 - p[0], torch.full_like(p[0], 100.0)]
    )


def _freudenstein_roth(p, data=None):
    return torch.stack(
        [
            -13.0 + p[0] + ((5.0 - p[1]) * p[1] - 2.0) * p[1],
            -29.0 + p[0] + ((p[1] + 1.0) * p[1] - 14.0) * p[1],
        ]
    )


def _beale(p, data=None):
    return torch.stack(
        [
            1.5 - p[0] * (1.0 - p[1]),
            2.25 - p[0] * (1.0 - p[1] ** 2),
            2.625 - p[0] * (1.0 - p[1] ** 3),
        ]
    )


def _hs01(p, data=None):
    """Hock-Schittkowski 01: Rosenbrock with p1 ≥ −1.5."""
    return torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])


def _hs21(p, data=None):
    """Hock-Schittkowski 21 objective as residuals: f = p0²/100 + p1² − 100;
    box 2 ≤ p0 ≤ 50, −50 ≤ p1 ≤ 50 → minimum at (2, 0)."""
    return torch.stack([p[0] / 10.0, p[1]])


def _hatfldb(p, data=None):
    """HATFLDB: r0 = p0 − 1, r_i = p_{i-1} − √p_i; box p ≥ 0, p1 ≤ 0.8."""
    safe = torch.clamp(p, min=0.0)
    return torch.stack(
        [
            p[0] - 1.0,
            p[0] - torch.sqrt(torch.clamp(safe[1], min=1e-30)),
            p[1] - torch.sqrt(torch.clamp(safe[2], min=1e-30)),
            p[2] - torch.sqrt(torch.clamp(safe[3], min=1e-30)),
        ]
    )




# Osborne's data-fitting problem: y(t) = p0 + p1·e^{−p3 t} + p2·e^{−p4 t},
# t = 10i, 33 samples (Moré-Garbow-Hillstrom #17; ``lmdemo.c`` problem 5).
_OSBORNE_Y = np.array(
    [8.44e-1, 9.08e-1, 9.32e-1, 9.36e-1, 9.25e-1, 9.08e-1, 8.81e-1,
     8.50e-1, 8.18e-1, 7.84e-1, 7.51e-1, 7.18e-1, 6.85e-1, 6.58e-1,
     6.28e-1, 6.03e-1, 5.80e-1, 5.58e-1, 5.38e-1, 5.22e-1, 5.06e-1,
     4.90e-1, 4.78e-1, 4.67e-1, 4.57e-1, 4.48e-1, 4.38e-1, 4.31e-1,
     4.24e-1, 4.20e-1, 4.14e-1, 4.11e-1, 4.06e-1]
)


def _osborne(p, data=None):
    t = 10.0 * torch.arange(33, dtype=p.dtype, device=p.device)
    y = torch.as_tensor(_OSBORNE_Y).to(p)
    return p[0] + p[1] * torch.exp(-p[3] * t) + p[2] * torch.exp(-p[4] * t) - y


def _repeated_scalar(f, n):
    """lmdemo replicates several scalar objectives as n identical residuals
    (bt3/hs48/hs51/modbt7); same construction here."""

    def residual(p, data=None):
        return f(p).expand(n)

    return residual


def _bt3_scalar(p):
    return (
        (p[0] - p[1]) ** 2 + (p[1] + p[2] - 2.0) ** 2
        + (p[3] - 1.0) ** 2 + (p[4] - 1.0) ** 2
    )


def _hs48_scalar(p):
    return (p[0] - 1.0) ** 2 + (p[1] - p[2]) ** 2 + (p[3] - p[4]) ** 2


def _modbt7_scalar(p):
    return 100.0 * (p[1] - p[0] ** 2) ** 2 + (p[0] - 1.0) ** 2


def _hatfldc(p, data=None):
    """HATFLDC: r0 = p0 − 1, r_i = p_{i−1} − √p_i (i=1,2), r3 = p3 − 1."""
    safe = torch.clamp(p, min=0.0)
    return torch.stack(
        [
            p[0] - 1.0,
            p[0] - torch.sqrt(torch.clamp(safe[1], min=1e-30)),
            p[1] - torch.sqrt(torch.clamp(safe[2], min=1e-30)),
            p[3] - 1.0,
        ]
    )


def _combustion(p, data=None):
    """Equilibrium combustion (Floudas et al.): 5 nonlinear equations in the
    propane-combustion product concentrations, box p ∈ [1e-4, 100]⁵."""
    r, r5 = 10.0, 0.193
    r6, r7 = 4.10622e-4, 5.45177e-4
    r8, r9, r10 = 4.4975e-7, 3.40735e-5, 9.615e-7
    p0, p1, p2, p3, p4 = p[0], p[1], p[2], p[3], p[4]
    return torch.stack(
        [
            p0 * p1 + p0 - 3.0 * p4,
            2.0 * p0 * p1 + p0 + 3.0 * r10 * p1 ** 2 + p1 * p2 ** 2
            + r7 * p1 * p2 + r9 * p1 * p3 + r8 * p1 - r * p4,
            2.0 * p1 * p2 ** 2 + r7 * p1 * p2 + 2.0 * r5 * p2 ** 2
            + r6 * p2 - 8.0 * p4,
            r9 * p1 * p3 + 2.0 * p3 ** 2 - 4.0 * r * p4,
            p0 * p1 + p0 + r10 * p1 ** 2 + p1 * p2 ** 2 + r7 * p1 * p2
            + r9 * p1 * p3 + r8 * p1 + r5 * p2 ** 2 + r6 * p2 + p3 ** 2 - 1.0,
        ]
    )


def _hs52_residuals(p, data=None):
    return torch.stack(
        [4.0 * p[0] - p[1], p[1] + p[2] - 2.0, p[3] - 1.0, p[4] - 1.0]
    )


def _mod2hs52(p, data=None):
    return torch.stack(
        [4.0 * p[0] - p[1], p[1] + p[2] - 2.0, p[3] - 1.0, p[4] - 1.0,
         p[0] - 0.5]
    )


def _mods235(p, data=None):
    return torch.stack([0.1 * (p[0] - 1.0), p[1] - p[0] ** 2])


def _modhs76(p, data=None):
    s = math.sqrt(0.5)
    return torch.stack([p[0], s * p[1], p[2], s * p[3]])


def make_expfit_data(dtype=np.float64):
    """Noise-free expfit data from known params (5.0, 0.1, 1.0) — the
    self-validating synthetic round trip of ``levmar/expfit.c:1-60``."""
    t = np.arange(40, dtype=dtype)
    y = 5.0 * np.exp(-0.1 * t) + 1.0
    return t, y


PROBLEMS: list[Problem] = [
    Problem("rosenbrock", _rosenbrock, (-1.2, 1.0), (1.0, 1.0)),
    Problem("powell", _powell, (3.0, 1.0), (0.0, 0.0), tol=1e-4),
    Problem("wood", _wood, (-3.0, -1.0, -3.0, -1.0), (1.0, 1.0, 1.0, 1.0)),
    Problem("helical_valley", _helical_valley, (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    Problem("meyer", _meyer, (8.85, 4.0, 2.5), (2.48, 6.18, 3.45), tol=2e-2),
    # box-constrained: interior solution
    Problem(
        "rosenbrock_box_interior", _rosenbrock, (-1.9, 1.0), (1.0, 1.0),
        lower=(-2.0, -1.5), upper=(3.0, 3.0),
    ),
    # box-constrained: solution on the boundary
    Problem(
        "quad_active_bounds", _quad_target, (0.0, 0.0), (1.0, 1.0),
        lower=(-5.0, -5.0), upper=(1.0, 1.0),
    ),
    # linear equality constrained (Hock-Schittkowski 28)
    Problem(
        "hs28_lec", _hs28_residual, (-4.0, 1.0, 1.0), (0.5, -0.5, 0.5),
        A=np.array([[1.0, 2.0, 3.0]]), b=np.array([1.0]),
    ),
    Problem(
        "expfit", _exponential_fit, (1.0, 0.0, 0.0), (5.0, 0.1, 1.0),
        data=tuple(torch.as_tensor(x) for x in make_expfit_data()),
    ),
    Problem(
        "modified_rosenbrock", _modified_rosenbrock, (-1.2, 1.0), (1.0, 1.0),
    ),
    Problem("freudenstein_roth", _freudenstein_roth, (6.0, 3.0), (5.0, 4.0)),
    Problem("beale", _beale, (1.0, 1.0), (3.0, 0.5), tol=1e-4),
    Problem(
        "hs01_box", _hs01, (-2.0, 1.0), (1.0, 1.0),
        lower=(float("-inf"), -1.5), upper=(float("inf"), float("inf")),
    ),
    Problem(
        "hs21_box", _hs21, (-1.0, -1.0), (2.0, 0.0),
        lower=(2.0, -50.0), upper=(50.0, 50.0),
    ),
    Problem(
        "hatfldb", _hatfldb, (0.1, 0.1, 0.1, 0.1),
        (0.947214, 0.8, 0.64, 0.4096),
        lower=(0.0, 0.0, 0.0, 0.0), upper=(100.0, 0.8, 100.0, 100.0),
        tol=1e-4,
    ),
    # —— the remainder of the lmdemo.c 21-problem set ——
    Problem(
        "osborne", _osborne, (0.5, 1.5, -1.0, 1e-2, 2e-2),
        (0.3754, 1.9358, -1.4647, 0.0129, 0.0221), tol=2e-3,
    ),
    Problem(
        "hatfldc", _hatfldc, (0.9, 0.9, 0.9, 0.9), (1.0, 1.0, 1.0, 1.0),
        lower=(0.0,) * 4, upper=(10.0,) * 4,
    ),
    Problem(
        "combustion", _combustion, (1e-4,) * 5,
        (0.0034, 31.3265, 0.0684, 0.8595, 0.0370),
        lower=(1e-4,) * 5, upper=(100.0,) * 5, tol=2e-3, itmax=5000,
    ),
    # linear-equality constrained (replicated-scalar objectives, lmdemo style)
    Problem(
        "bt3_lec", _repeated_scalar(_bt3_scalar, 5), (2.0,) * 5,
        (-0.76744, 0.25581, 0.62791, -0.11628, 0.25581),
        A=np.array([[1.0, 3.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0, 1.0, -2.0],
                    [0.0, 1.0, 0.0, 0.0, -1.0]]),
        b=np.zeros(3), tol=1e-4,
    ),
    Problem(
        "hs48_lec", _repeated_scalar(_hs48_scalar, 5), (3.0, 5.0, -3.0, 2.0, -2.0),
        (1.0, 1.0, 1.0, 1.0, 1.0),
        A=np.array([[1.0, 1.0, 1.0, 1.0, 1.0],
                    [0.0, 0.0, 1.0, -2.0, -2.0]]),
        b=np.array([5.0, -3.0]), tol=1e-4,
    ),
    Problem(
        "hs51_lec", _repeated_scalar(_bt3_scalar, 5), (2.5, 0.5, 2.0, -1.0, 0.5),
        (1.0, 1.0, 1.0, 1.0, 1.0),
        A=np.array([[1.0, 3.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0, 1.0, -2.0],
                    [0.0, 1.0, 0.0, 0.0, -1.0]]),
        b=np.array([4.0, 0.0, 0.0]), tol=1e-4,
    ),
    # box + linear-equality constrained
    Problem(
        "mod1hs52_blec", _hs52_residuals, (2.0,) * 5,
        (-0.09, 0.03, 0.25, -0.19, 0.03),
        lower=(-0.09, 0.0, float("-inf"), -0.2, 0.0),
        upper=(float("inf"), 0.3, 0.25, 0.3, 0.3),
        A=np.array([[1.0, 3.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0, 1.0, -2.0],
                    [0.0, 1.0, 0.0, 0.0, -1.0]]),
        b=np.zeros(3), penalty_weight=2000.0, tol=1e-3,
    ),
    Problem(
        "mods235_blec", _mods235, (-2.0, 3.0, 1.0), (-1.725, 2.9, 0.725),
        lower=(float("-inf"), 0.1, 0.7), upper=(float("inf"), 2.9, float("inf")),
        A=np.array([[1.0, 0.0, 1.0], [0.0, 1.0, -4.0]]),
        b=np.array([-1.0, 0.0]), tol=1e-3,
    ),
    Problem(
        "modbt7_blec", _repeated_scalar(_modbt7_scalar, 5), (-2.0, 1.0, 1.0, 1.0, 1.0),
        (0.7, 0.49, 0.19, 1.19, -0.2),
        lower=(float("-inf"),) * 4 + (-0.3,),
        upper=(0.7,) + (float("inf"),) * 4,
        A=np.array([[1.0, 1.0, -1.0, 0.0, 0.0],
                    [1.0, 1.0, 0.0, -1.0, 0.0],
                    [1.0, 0.0, 0.0, 0.0, 1.0]]),
        b=np.array([1.0, 0.0, 0.5]), tol=1e-3, itmax=2000,
    ),
    # linear-inequality constrained (C p ≥ d)
    Problem(
        "mod2hs52_lic", _mod2hs52, (2.0,) * 5, (0.5, 2.0, 0.0, 1.0, 1.0),
        C=np.array([[1.0, 3.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0, 1.0, -2.0],
                    [0.0, -1.0, 0.0, 0.0, 1.0]]),
        d=np.array([-1.0, -2.0, -7.0]), tol=1e-3,
    ),
    Problem(
        "modhs76_bleic", _modhs76, (0.5,) * 4,
        (0.0, 0.00909091, 0.372727, 0.354545),
        lower=(0.0,) * 4,
        A=np.array([[0.0, 1.0, 4.0, 0.0]]), b=np.array([1.5]),
        C=np.array([[-1.0, -2.0, -1.0, -1.0], [-3.0, -1.0, -2.0, 1.0]]),
        d=np.array([-5.0, -0.4]), tol=1e-3,
    ),
]
