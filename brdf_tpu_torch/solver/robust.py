"""Robust IRLS reweighting and sensor-saturation masking.

Port of ``brdf_tpu/solver/robust.py``: the same ψ-weights, the same
per-texel scale (masked median by sorting with +inf on masked entries).
With ``axis_name`` (a view axis sharded over the ranks of the current mesh,
``parallel/mesh.py``) the median gathers a texel's residuals from every rank
of the axis first, so it sorts the same views the unsharded fit sorts; the
JAX package gets the same from XLA's partitioner.
"""

from __future__ import annotations

import torch

from brdf_tpu_torch.parallel.mesh import axis_gather

_MAD_TO_SIGMA = 1.4826
_TUNING = {"huber": 1.345, "cauchy": 2.385, "tukey": 4.685}


def saturation_weights(intensity: torch.Tensor, threshold: float = 0.98) -> torch.Tensor:
    """1.0 for trustworthy measurements, 0.0 at/above the sensor ceiling."""
    return (intensity < threshold).to(intensity.dtype)


def _sigma(residuals: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-texel robust scale over the last axis: weighted median |r| × 1.4826."""
    r = torch.abs(residuals)
    masked = torch.where(weights > 0, r, torch.full_like(r, float("inf")))
    srt = torch.sort(masked, dim=-1).values
    n_eff = torch.sum(weights > 0, dim=-1)
    idx = torch.clamp(n_eff // 2, min=0)
    med = torch.gather(srt, -1, idx[..., None])[..., 0]
    med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
    return _MAD_TO_SIGMA * med


def robust_weights(
    residuals: torch.Tensor,
    base_weights: torch.Tensor,
    kind: str = "huber",
    tuning: float | None = None,
    min_sigma: float = 1e-3,
    axis_name: str | None = None,
) -> torch.Tensor:
    """IRLS weights √(ψ(r)/r) per measurement, composed with ``base_weights``;
    the robust scale is estimated per texel over its views (last axis, and
    across the ranks of ``axis_name``)."""
    if kind not in _TUNING:
        raise ValueError(f"unknown robust kind {kind!r}")
    c = _TUNING[kind] if tuning is None else tuning
    sigma = _sigma(axis_gather(residuals, axis_name, dim=-1),
                   axis_gather(base_weights, axis_name, dim=-1))
    sigma = torch.clamp(sigma, min=min_sigma)
    u = torch.abs(residuals) / (c * sigma[..., None])
    one = torch.ones_like(u)
    if kind == "huber":
        w = torch.minimum(one, 1.0 / torch.clamp(u, min=1e-12))
        w = torch.where(u <= 1.0, one, w)
    elif kind == "cauchy":
        w = 1.0 / (1.0 + u * u)
    else:  # tukey biweight
        w = torch.where(u < 1.0, (1.0 - u * u) ** 2, torch.zeros_like(u))
    return base_weights * torch.sqrt(w)
