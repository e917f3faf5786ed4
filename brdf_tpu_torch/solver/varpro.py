"""Variable-projection (VarPro) solver for separable lobe fits, unfused tier.

Port of ``brdf_tpu/solver/varpro.py::varpro_fit`` (its ``axis_name`` view
sharding dropped). Each separable lobe is ``I = kd·a + ks·b(σ)``; the linear
pair is eliminated in closed form by :func:`_bvls2` and the 1-D profiled
objective is minimised by a safeguarded Newton iteration in log σ (exponent)
or σ (roughness), with Kaufman's projected curvature and a trust-clipped
accept-if-better step. The fused kernel (``ops/varpro.py``) shares
:func:`_bvls2` and the same Newton; this tier differs only in its default
init (``linear_grid_init(refine=True)``) and in evaluating ∂b/∂σ by a JVP.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.solver.init import linear_grid_init

_TINY = 1e-30

# separable m=3 lobes → σ transform: log for the exponent, identity for the
# bounded roughness parameters
_SEPARABLE = {
    "blinn_phong": "log",
    "phong": "log",
    "cook_torrance": "linear",
    "ward": "linear",
}


def _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1):
    """Exact 2-variable box-constrained least squares from Gram entries:
    the interior stationary point or the best of the four clamped edges."""

    def cost(x0, x1):
        return x0 * x0 * aa + x1 * x1 * bb + 2.0 * x0 * x1 * ab - 2.0 * (x0 * ay + x1 * by)

    det = aa * bb - ab * ab
    det_ok = torch.abs(det) > 1e-30
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    xi0 = (bb * ay - ab * by) / det_s
    xi1 = (aa * by - ab * ay) / det_s
    interior_ok = det_ok & (xi0 >= l0) & (xi0 <= u0) & (xi1 >= l1) & (xi1 <= u1)

    def solve1(num, den, lo, hi):
        return torch.clamp(num / torch.clamp(den, min=1e-30), lo, hi)

    cands = []
    for x0_fixed in (l0, u0):
        cands.append((torch.full_like(ay, x0_fixed), solve1(by - x0_fixed * ab, bb, l1, u1)))
    for x1_fixed in (l1, u1):
        cands.append((solve1(ay - x1_fixed * ab, aa, l0, u0), torch.full_like(ay, x1_fixed)))

    best0, best1 = cands[0]
    best_c = cost(best0, best1)
    for x0c, x1c in cands[1:]:
        c = cost(x0c, x1c)
        take = c < best_c
        best0 = torch.where(take, x0c, best0)
        best1 = torch.where(take, x1c, best1)
        best_c = torch.where(take, c, best_c)
    take_i = interior_ok & (cost(xi0, xi1) < best_c)
    return torch.where(take_i, xi0, best0), torch.where(take_i, xi1, best1)


class VarProResult(NamedTuple):
    p: torch.Tensor       # (T, 3) kd, ks, σ
    chi2: torch.Tensor    # (T,) final profiled χ²
    iters: torch.Tensor   # (T,) accepted Newton steps
    stop: torch.Tensor    # (T,) int32: 2 = converged (small step), 3 = k done
    g_abs: torch.Tensor   # (T,) |φ'| at the final point (transformed coords)


def sigma_domain(model: str, lo, hi) -> tuple[bool, float, float, float]:
    """(use_log, σ floor, s_lo, s_hi): the Newton coordinate's box. The
    exponent floor 0.25 keeps ∂b/∂(log σ) ∝ σ away from zero, where a lane
    could never climb out."""
    use_log = _SEPARABLE[model] == "log"
    sig_floor = max(float(lo[2]), 0.25) if use_log else max(float(lo[2]), 1e-6)
    s_lo = float(np.log(sig_floor)) if use_log else sig_floor
    s_hi = float(np.log(hi[2])) if use_log else float(hi[2])
    return use_log, sig_floor, s_lo, s_hi


def varpro_fit(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,          # (T, V)
    weights: torch.Tensor | None = None,
    p0: torch.Tensor | None = None,   # (T, 3) optional start (else grid init)
    iters: int = 8,
    lower: tuple | None = None,
    upper: tuple | None = None,
) -> VarProResult:
    """Fit T independent separable lobes by profiled 1-D Newton."""
    if model not in _SEPARABLE:
        raise ValueError(
            f"varpro_fit supports separable m=3 lobes {sorted(_SEPARABLE)}, got {model!r}"
        )
    spec = MODELS[model]
    dtype = target.dtype
    lo = np.asarray(spec.lower if lower is None else lower, np.float64)
    hi = np.asarray(spec.upper if upper is None else upper, np.float64)
    if weights is None:
        weights = torch.ones_like(target)
    w = weights.to(dtype)
    use_log, sig_floor, s_lo, s_hi = sigma_domain(model, lo, hi)

    if p0 is None:
        p0 = linear_grid_init(model, angles, target, weights=w, refine=True)
    sigma0 = torch.clamp(p0[..., 2], sig_floor, float(hi[2]))
    t0 = torch.log(sigma0) if use_log else sigma0

    # the residual is formed directly, never by the Gram identity, whose f32
    # cancellation would floor χ² and break the accept test
    yw = target * w
    mid = torch.tensor([1.0, 0.0, lo[2] + 0.5 * (hi[2] - lo[2])], dtype=dtype,
                       device=target.device)
    aw = spec.fn(mid, angles) * w
    aa = torch.sum(aw * aw, -1)
    ay = torch.sum(aw * yw, -1)
    l0, u0, l1, u1 = float(lo[0]), float(hi[0]), float(lo[1]), float(hi[1])

    def basis_b(sig):
        p = torch.stack([torch.zeros_like(sig), torch.ones_like(sig), sig], -1)
        return spec.fn(p, angles)

    def eval_at(t_var):
        sig = torch.exp(t_var) if use_log else t_var
        b, db = torch.func.jvp(basis_b, (sig,), (torch.ones_like(sig),))
        if use_log:
            db = db * sig[..., None]
        bw = b * w
        dbw = db * w
        ab = torch.sum(aw * bw, -1)
        bb = torch.sum(bw * bw, -1)
        by = torch.sum(bw * yw, -1)
        kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
        rw = yw - kd[..., None] * aw - ks[..., None] * bw
        chi2 = torch.sum(rw * rw, -1)
        g = -2.0 * ks * torch.sum(rw * dbw, -1)
        a_db = torch.sum(aw * dbw, -1)
        b_db = torch.sum(bw * dbw, -1)
        det = aa * bb - ab * ab
        det_ok = det > _TINY
        det_s = torch.where(det_ok, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        x1 = torch.where(det_ok, (bb * a_db - ab * b_db) / det_s, zero)
        x2 = torch.where(det_ok, (aa * b_db - ab * a_db) / det_s, zero)
        proj = torch.sum(dbw * dbw, -1) - x1 * a_db - x2 * b_db
        h = 2.0 * ks * ks * torch.clamp(proj, min=0.0)
        return chi2, g, h, kd, ks

    t_best = t0
    chi2_b, g_b, h_b, kd_b, ks_b = eval_at(t_best)
    span = s_hi - s_lo
    trust = torch.full_like(t0, 0.25) * span
    n_acc = torch.zeros_like(t0, dtype=torch.int32)
    for _ in range(iters):
        step = torch.minimum(torch.maximum(-g_b / torch.clamp(h_b, min=_TINY), -trust), trust)
        t_new = torch.clamp(t_best + step, s_lo, s_hi)
        chi2_n, g_n, h_n, kd_n, ks_n = eval_at(t_new)
        ok = (chi2_n < chi2_b) & torch.isfinite(chi2_n)
        t_best = torch.where(ok, t_new, t_best)
        chi2_b = torch.where(ok, chi2_n, chi2_b)
        g_b = torch.where(ok, g_n, g_b)
        h_b = torch.where(ok, h_n, h_b)
        kd_b = torch.where(ok, kd_n, kd_b)
        ks_b = torch.where(ok, ks_n, ks_b)
        trust = torch.where(ok, torch.clamp(trust * 2.0, max=span), trust * 0.25)
        n_acc = n_acc + ok.to(torch.int32)

    sigma = torch.exp(t_best) if use_log else t_best
    kd_f = torch.clamp(kd_b, l0, u0)
    ks_f = torch.clamp(ks_b, l1, u1)
    stop = torch.where(trust < 1e-6 * span, 2, 3).to(torch.int32)
    return VarProResult(
        p=torch.stack([kd_f, ks_f, sigma], -1).to(dtype),
        chi2=torch.clamp(chi2_b, min=0.0), iters=n_acc, stop=stop, g_abs=torch.abs(g_b),
    )
