"""Extended constrained LM variants: box + linear equalities + inequalities.

Port of ``brdf_tpu/solver/constrained.py``, on top of the core solvers in
:mod:`brdf_tpu_torch.solver.lm`:

- :func:`levmar_blec` — box + linear equality (``LEVMAR_BLEC_DER/DIF``,
  ``levmar/lmblec_core.c``): one hinge penalty residual per finite bound side
  appended to the measurement vector, then null-space-eliminated LM over
  the equality manifold.
- :func:`levmar_bleic` — box + linear equality + inequality
  (``LEVMAR_BLEIC_DER/DIF``, ``levmar/lmbleic_core.c:93-120``): each
  inequality ``C p ≥ d`` gains a surplus variable ``y ≥ 0`` turning it into
  the equality ``C p − y = d``; the augmented problem is a blec problem.
- :func:`levmar_blic` / :func:`levmar_leic` / :func:`levmar_lic` —
  convenience wrappers (``levmar.h:155-202``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from brdf_tpu_torch.solver.lm import LMOptions, LMResult, levmar_lec

_BC_WEIGHT = 1e4   # penalty weight (levmar's __BLEC_WEIGHT analogue)


def _box(lower, upper, m: int):
    lo = np.full(m, -np.inf) if lower is None else np.broadcast_to(np.asarray(lower, float), (m,))
    hi = np.full(m, np.inf) if upper is None else np.broadcast_to(np.asarray(upper, float), (m,))
    return lo, hi


def levmar_blec(
    residual_fn,
    p0: torch.Tensor,
    A,
    b,
    lower=None,
    upper=None,
    data: Any = None,
    opts: LMOptions = LMOptions(),
    penalty_weight: float = _BC_WEIGHT,
    data_axes: Any = 0,
) -> LMResult:
    """Box + linear-equality constrained LM via box penalties + elimination.

    The reported point is clamped into the box (the penalties keep it within
    ~1/w of it) and the pre-clamp violation is returned in
    ``constraint_violation``, so that a penalty-weight failure shows."""
    m = p0.shape[-1]
    lo, hi = _box(lower, upper, m)
    # One hinge residual per finite bound side: r = w·max(l−p, 0) (and
    # symmetrically for the upper side); hinges stay well-scaled for any box,
    # where levmar's box-normalized c²−1 collapses for one-sided boxes
    lo_idx = np.nonzero(np.isfinite(lo))[0]
    hi_idx = np.nonzero(np.isfinite(hi))[0]
    lo_j = torch.as_tensor(lo_idx, device=p0.device)
    hi_j = torch.as_tensor(hi_idx, device=p0.device)
    lo_v = torch.as_tensor(lo[lo_idx]).to(p0)
    hi_v = torch.as_tensor(hi[hi_idx]).to(p0)
    w = float(penalty_weight)

    def aug_residual(p, d):
        r = residual_fn(p, d)
        parts = [r]
        if len(lo_idx):
            parts.append(w * torch.clamp(lo_v - p[..., lo_j], min=0.0))
        if len(hi_idx):
            parts.append(w * torch.clamp(p[..., hi_j] - hi_v, min=0.0))
        return torch.cat(parts, dim=-1) if len(parts) > 1 else r

    res = levmar_lec(aug_residual, p0, A, b, data=data, opts=opts, data_axes=data_axes)
    lo_a = torch.as_tensor(lo).to(p0)
    hi_a = torch.as_tensor(hi).to(p0)
    # infinite bounds contribute −inf → max(·, 0) = 0, so no masking needed
    violation = torch.amax(
        torch.clamp(torch.maximum(lo_a - res.p, res.p - hi_a), min=0.0), dim=-1)
    p_clamped = torch.minimum(torch.maximum(res.p, lo_a), hi_a)
    return res._replace(p=p_clamped, constraint_violation=violation)


def levmar_bleic(
    residual_fn,
    p0: torch.Tensor,
    A,
    b,
    C,
    d,
    lower=None,
    upper=None,
    data: Any = None,
    opts: LMOptions = LMOptions(),
    data_axes: Any = 0,
) -> LMResult:
    """Box + linear equality + inequality (``C p ≥ d``) constrained LM.

    Augments with surplus variables ``y ≥ 0``: ``C p − y = d`` becomes an
    equality; the augmented problem is box+lec (``lmbleic_core.c:93-120``).
    """
    m = p0.shape[-1]
    C = np.asarray(C, float)
    d = np.asarray(d, float)
    k2 = C.shape[0]

    if A is None:
        A_full = np.concatenate([C, -np.eye(k2)], axis=1)
        b_full = d
    else:
        A = np.asarray(A, float)
        b = np.asarray(b, float)
        A_full = np.block([[A, np.zeros((A.shape[0], k2))], [C, -np.eye(k2)]])
        b_full = np.concatenate([b, d])

    lo, hi = _box(lower, upper, m)
    lo_full = np.concatenate([lo, np.zeros(k2)])      # surplus y ≥ 0
    hi_full = np.concatenate([hi, np.full(k2, np.inf)])

    y0 = torch.clamp(p0 @ torch.as_tensor(C.T).to(p0) - torch.as_tensor(d).to(p0), min=0.0)
    p0_full = torch.cat([p0, y0], dim=-1)

    def wrapped(p_aug, dd):
        return residual_fn(p_aug[..., :m], dd)

    res = levmar_blec(
        wrapped, p0_full, A_full, b_full, lower=lo_full, upper=hi_full, data=data, opts=opts,
        data_axes=data_axes,
    )
    return res._replace(p=res.p[..., :m])


def levmar_blic(residual_fn, p0, C, d, lower=None, upper=None, **kw) -> LMResult:
    """Box + linear inequalities only."""
    return levmar_bleic(residual_fn, p0, None, None, C, d, lower, upper, **kw)


def levmar_leic(residual_fn, p0, A, b, C, d, **kw) -> LMResult:
    """Linear equalities + inequalities only."""
    return levmar_bleic(residual_fn, p0, A, b, C, d, None, None, **kw)


def levmar_lic(residual_fn, p0, C, d, **kw) -> LMResult:
    """Linear inequalities only."""
    return levmar_bleic(residual_fn, p0, None, None, C, d, None, None, **kw)
