"""Fit statistics: covariance, standard deviations, correlations, R².

Port of ``brdf_tpu/solver/stats.py``, the levmar N10 component
(``dlevmar_covar/stddev/corcoef/R2``, ``levmar/misc_core.c:564-658``):
every function takes a leading batch of fits.
"""

from __future__ import annotations

import torch

from brdf_tpu_torch.solver.lm import _add_batch, _axes_of


# matrices a batched eigen or SVD call takes at once: cuSOLVER's batched
# symmetric eigensolver refused a batch of 313353 3 × 3 matrices
# (CUSOLVER_STATUS_INVALID_VALUE) on the card
_CHUNK = 16384


def _by_chunks(fn, mats: torch.Tensor) -> torch.Tensor:
    flat = mats.reshape(-1, *mats.shape[-2:])
    out = torch.cat([fn(part) for part in torch.split(flat, _CHUNK)]) if len(flat) else fn(flat)
    return out.reshape(*mats.shape[:-2], *out.shape[1:])


def covariance_from_normal(jtj: torch.Tensor, chi2: torch.Tensor, n_meas) -> torch.Tensor:
    """``σ² (JᵀJ)⁺`` from the normal matrix ``jtj (..., m, m)``, with
    ``σ² = χ²/(n − r)`` and ``r = rank(JᵀJ)`` (``LEVMAR_COVAR``,
    ``misc_core.c:564-591``); ``n_meas`` is a number or a tensor of the
    batch's shape. A matrix with a non-finite entry gives a NaN covariance,
    as XLA's factorizations give it (LAPACK's and cuSOLVER's refuse it)."""
    m = jtj.shape[-1]
    eps = torch.finfo(jtj.dtype).eps
    bad = ~torch.isfinite(jtj).all(-1).all(-1)
    eye = torch.eye(m, dtype=jtj.dtype, device=jtj.device)
    jtj = torch.where(bad[..., None, None], eye, jtj)
    # rank via eigenvalues of the symmetric PSD JᵀJ
    eig = _by_chunks(torch.linalg.eigvalsh, jtj)
    tol = torch.amax(eig, dim=-1, keepdim=True) * m * eps
    rank = torch.sum(eig > tol, dim=-1)
    dof = torch.clamp(torch.as_tensor(n_meas, device=jtj.device) - rank, min=1)
    sigma2 = chi2 / dof
    # jnp.linalg.pinv's default cutoff: 10 · max(m, n) · eps of the largest
    # singular value
    pinv = _by_chunks(lambda a: torch.linalg.pinv(a, rtol=10.0 * m * eps), jtj)
    cov = sigma2[..., None, None] * pinv
    return torch.where(bad[..., None, None], torch.full_like(cov, float("nan")), cov)


def covariance(jac: torch.Tensor, chi2: torch.Tensor, n_meas) -> torch.Tensor:
    """Covariance of the fitted parameters from the Jacobian ``jac (..., n, m)``
    (see :func:`covariance_from_normal`)."""
    return covariance_from_normal(jac.transpose(-1, -2) @ jac, chi2, n_meas)


def stddev(cov: torch.Tensor) -> torch.Tensor:
    """Per-parameter standard deviations √C_jj (``misc_core.c:598-610``)."""
    return torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=0.0))


def corcoef(cov: torch.Tensor) -> torch.Tensor:
    """Pearson correlation matrix ρ_ij = C_ij/√(C_ii C_jj)
    (``misc_core.c:613-630``)."""
    sd = stddev(cov)
    denom = sd[..., :, None] * sd[..., None, :]
    return cov / torch.clamp(denom, min=1e-30)


def r_squared(pred: torch.Tensor, target: torch.Tensor, axis=-1) -> torch.Tensor:
    """Coefficient of determination R² = 1 − Σ(y−ŷ)²/Σ(y−ȳ)²
    (``LEVMAR_R2``, ``misc_core.c:633-658``)."""
    ss_res = torch.sum((target - pred) ** 2, dim=axis)
    mean = torch.mean(target, dim=axis, keepdim=True)
    ss_tot = torch.sum((target - mean) ** 2, dim=axis)
    return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-30)


def fit_statistics(residual_fn, p, data, target, data_axes=0):
    """Bundle: (covariance, stddev, corcoef, R²) for the fitted batch ``p``
    (``(B, m)``, or ``(m,)`` for one fit). ``residual_fn(p, data)`` returns
    residuals ``pred − target``, so predictions are recovered as
    ``target + r``."""
    def one(p_i, d_i):
        r = residual_fn(p_i, d_i)
        j = torch.func.jacfwd(lambda q: residual_fn(q, d_i))(p_i)
        return r, j

    d_axes = _axes_of(data, data_axes)
    batched = p.ndim == 2
    if not batched:
        p, data = p[None], _add_batch(data, d_axes)
    r, j = torch.func.vmap(one, in_dims=(0, d_axes))(p, data)
    if not batched:
        r, j = r[0], j[0]
    chi2 = torch.sum(r * r, dim=-1)
    cov = covariance(j, chi2, r.shape[-1])
    pred = target + r
    return {
        "covariance": cov,
        "stddev": stddev(cov),
        "corcoef": corcoef(cov),
        "r2": r_squared(pred, target),
        "chi2": chi2,
    }
