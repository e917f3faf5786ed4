"""Variable projection for the m=9 joint normal-map fit.

Port of ``brdf_tpu/solver/varpro_joint.py`` in eager PyTorch (the JAX package
has no kernel on this path either). The joint parameter vector
[kd_rgb, ks_rgb, σ, ou, ov] is separable: given the nonlinear triple
α = (σ, ou, ov), every channel's (kd_c, ks_c) solves a 2-variable
box-constrained least squares against the shared bases

    a(α) = diffuse lobe at the perturbed normal      (σ-independent)
    b(α) = unit-ks specular lobe at (σ, perturbed normal)

so the 9-parameter problem profiles down to 3-D Newton on

    φ(α) = Σ_c min_{kd_c,ks_c ∈ box} ‖y_c − kd_c·a(α) − ks_c·b(α)‖²_w.

Per iteration: one basis evaluation and three forward-mode derivatives
(∂(a,b)/∂α_j, ``torch.func.jvp`` through ``perturbed_angles``), three
closed-form BVLS solves, a Kaufman-projected 3×3 Gauss-Newton system solved
by Cramer, and a trust-clipped accept-if-better step, for a fixed iteration
count. The LM tiers of ``fit_joint_normalmap`` (engines "xla"/"pallas")
remain the general path; this tier is their alternative for separable base
lobes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles, angles_from_geometry
from brdf_tpu_torch.models.normalmap import (
    JointSpec,
    joint_p0_from_channelwise,
    joint_spec,
    perturbed_angles,
)
from brdf_tpu_torch.solver.init import linear_grid_init
from brdf_tpu_torch.solver.varpro import _SEPARABLE, _bvls2

_TINY = 1e-30


class JointVarProResult(NamedTuple):
    p: torch.Tensor       # (T, 9)
    chi2: torch.Tensor    # (T,)
    iters: torch.Tensor   # (T,) accepted steps
    stop: torch.Tensor    # (T,) 2 = converged (trust collapsed), 3 = k done
    g_inf: torch.Tensor   # (T,) ‖∇φ‖∞ at the final point


def _solve3(h, g):
    """Batched 3×3 Cramer solve ``dα = −H⁻¹ g`` (h dict of (j,k) entries)."""
    c00 = h[(1, 1)] * h[(2, 2)] - h[(1, 2)] * h[(1, 2)]
    c01 = h[(0, 2)] * h[(1, 2)] - h[(0, 1)] * h[(2, 2)]
    c02 = h[(0, 1)] * h[(1, 2)] - h[(0, 2)] * h[(1, 1)]
    c11 = h[(0, 0)] * h[(2, 2)] - h[(0, 2)] * h[(0, 2)]
    c12 = h[(0, 1)] * h[(0, 2)] - h[(0, 0)] * h[(1, 2)]
    c22 = h[(0, 0)] * h[(1, 1)] - h[(0, 1)] * h[(0, 1)]
    det = h[(0, 0)] * c00 + h[(0, 1)] * c01 + h[(0, 2)] * c02
    ok = torch.abs(det) > _TINY
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    d0 = -(c00 * g[0] + c01 * g[1] + c02 * g[2]) * inv
    d1 = -(c01 * g[0] + c11 * g[1] + c12 * g[2]) * inv
    d2 = -(c02 * g[0] + c12 * g[1] + c22 * g[2]) * inv
    return (d0, d1, d2), ok


def varpro_fit_joint(
    base_model: str,
    geom,                      # ShadingGeometry (T texels)
    target: torch.Tensor,      # (T, V, 3)
    weights: torch.Tensor | None = None,   # (T, V) or per-channel (T, V, 3)
    channel_params: torch.Tensor | None = None,   # (T, 3, 3) per-channel init
    iters: int = 12,
    max_tilt: float = 0.6,
) -> tuple[JointVarProResult, JointSpec]:
    """Joint normal + material fit by 3-D profiled Newton."""
    if base_model not in _SEPARABLE:
        raise ValueError(f"joint varpro needs a separable base lobe, got {base_model!r}")
    with torch.no_grad():
        res = _impl(base_model, geom, target, weights, channel_params, int(iters), float(max_tilt))
    return res, joint_spec(base_model, max_tilt=max_tilt)


def _impl(base_model, geom, target, weights, channel_params, iters, max_tilt) -> JointVarProResult:
    base = MODELS[base_model]
    dtype = target.dtype
    if weights is None:
        weights = torch.ones(target.shape[:2], dtype=dtype, device=target.device)
    w = weights.to(dtype)                         # (T, V) or (T, V, 3)
    # per-channel weights: channels are independent measurements, so a
    # per-channel saturation/IRLS mask makes the Gram per-channel too
    w3 = (w[..., None] if w.ndim == 2 else w).expand(target.shape)
    yw = target * w3                              # (T, V, 3)

    use_log = _SEPARABLE[base_model] == "log"
    sig_floor = max(base.lower[2], 0.25) if use_log else max(base.lower[2], 1e-6)
    s_lo = float(np.log(sig_floor)) if use_log else float(sig_floor)
    s_hi = float(np.log(base.upper[2])) if use_log else float(base.upper[2])
    lo_a = torch.tensor([s_lo, -max_tilt, -max_tilt], dtype=dtype, device=target.device)
    hi_a = torch.tensor([s_hi, max_tilt, max_tilt], dtype=dtype, device=target.device)
    span = float(np.sqrt((s_hi - s_lo) ** 2 + 2 * (2 * max_tilt) ** 2))
    l0, u0 = float(base.lower[0]), float(base.upper[0])
    l1, u1 = float(base.lower[1]), float(base.upper[1])

    if channel_params is None:
        # every channel in one call: the angles (T, 1, V) broadcast against
        # the (T, 3, V) measurements → (T, 3, m); contiguous, so that the view
        # sums run as in a call for one channel
        ang0 = ShadingAngles(*(None if a is None else a[:, None]
                               for a in angles_from_geometry(geom)))
        channel_params = linear_grid_init(base_model, ang0, target.transpose(1, 2).contiguous(),
                                          weights=w3.transpose(1, 2).contiguous())
    p0 = joint_p0_from_channelwise(channel_params)          # (T, 9)
    sig0 = torch.clamp(p0[..., 6], sig_floor, float(base.upper[2]))
    t0_sig = torch.log(sig0) if use_log else sig0

    def bases(alpha):
        """α (T, 3) → (a, b) each (T, V)."""
        sig = torch.exp(alpha[..., 0]) if use_log else alpha[..., 0]
        ang = perturbed_angles(geom, alpha[..., 1], alpha[..., 2])
        one = torch.ones_like(sig)
        zero = torch.zeros_like(sig)
        a = base.fn(torch.stack([one, zero, sig], -1), ang)
        b = base.fn(torch.stack([zero, one, sig], -1), ang)
        return a, b

    def gram(a, b, c):
        wc = w3[..., c]
        aw = a * wc
        bw = b * wc
        return (wc, aw, bw, torch.sum(aw * aw, -1), torch.sum(aw * bw, -1), torch.sum(bw * bw, -1),
                torch.sum(aw * yw[..., c], -1), torch.sum(bw * yw[..., c], -1))

    def chi2_at(alpha):
        """Profiled χ² only (no derivatives): the multi-start scorer."""
        a, b = bases(alpha)
        chi2 = torch.zeros(alpha.shape[:-1], dtype=dtype, device=alpha.device)
        for c in range(3):
            _, aw, bw, aa, ab, bb, ay, by = gram(a, b, c)
            kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
            rw = yw[..., c] - kd[..., None] * aw - ks[..., None] * bw
            chi2 = chi2 + torch.sum(rw * rw, -1)
        return chi2

    def eval_at(alpha):
        """φ, ∇φ (3), projected-GN H (3×3 upper), per-channel (kd, ks).

        Per-channel weights make the (a, b) Gram per-channel, so the BVLS
        and the Kaufman projection run inside the channel loop."""
        a, b = bases(alpha)
        tangents = []
        for j in range(3):
            e = torch.zeros_like(alpha)
            e[..., j] = 1.0
            _, (da_j, db_j) = torch.func.jvp(bases, (alpha,), (e,))
            tangents.append((da_j, db_j))

        chi2 = torch.zeros(alpha.shape[:-1], dtype=dtype, device=alpha.device)
        g = [torch.zeros_like(chi2) for _ in range(3)]
        h = {(j, k): torch.zeros_like(chi2) for j in range(3) for k in range(j, 3)}
        kds, kss = [], []
        for c in range(3):
            wc, aw, bw, aa, ab, bb, ay, by = gram(a, b, c)
            det = aa * bb - ab * ab
            det_ok = det > _TINY
            det_s = torch.where(det_ok, det, torch.ones_like(det))
            zero = torch.zeros_like(det)

            def project(u):
                """u (T,V) → component ⊥ span{aw, bw} (per texel, channel c)."""
                ua = torch.sum(u * aw, -1)
                ub = torch.sum(u * bw, -1)
                x1 = torch.where(det_ok, (bb * ua - ab * ub) / det_s, zero)
                x2 = torch.where(det_ok, (aa * ub - ab * ua) / det_s, zero)
                return u - x1[..., None] * aw - x2[..., None] * bw

            kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
            kds.append(kd)
            kss.append(ks)
            rw = yw[..., c] - kd[..., None] * aw - ks[..., None] * bw
            chi2 = chi2 + torch.sum(rw * rw, -1)
            u_cols = []
            for j in range(3):
                da_j, db_j = tangents[j]
                u = (kd[..., None] * da_j + ks[..., None] * db_j) * wc
                g[j] = g[j] - 2.0 * torch.sum(rw * u, -1)
                u_cols.append(project(u))
            for j in range(3):
                for k in range(j, 3):
                    h[(j, k)] = h[(j, k)] + 2.0 * torch.sum(u_cols[j] * u_cols[k], -1)
        return chi2, g, h, torch.stack(kds, -1), torch.stack(kss, -1)

    # Offset multi-start: the profiled landscape over (ou, ov) has local
    # minima (a wrong normal can half-explain the data with a rougher,
    # brighter lobe), and a single (0, 0) start strands the lanes whose true
    # tilt is large. Nine offset candidates spaced to put every
    # |offset| ≤ max_tilt inside a Newton basin fix the tail for nine extra
    # profiled evaluations — the same medicine as the 1-D shape grid in
    # linear_grid_init.
    step_o = 0.55 * max_tilt
    alpha0 = None
    chi2_best = None
    for du in (-step_o, 0.0, step_o):
        for dv in (-step_o, 0.0, step_o):
            cand = torch.stack([t0_sig, torch.full_like(t0_sig, du), torch.full_like(t0_sig, dv)],
                               dim=-1)
            c = chi2_at(cand)
            if alpha0 is None:
                alpha0, chi2_best = cand, c
            else:
                better = c < chi2_best
                alpha0 = torch.where(better[..., None], cand, alpha0)
                chi2_best = torch.where(better, c, chi2_best)

    alpha = alpha0
    chi2_b, g_b, h_b, kd_b, ks_b = eval_at(alpha)
    trust = torch.full(alpha.shape[:-1], 0.2 * span, dtype=dtype, device=alpha.device)
    n_acc = torch.zeros(alpha.shape[:-1], dtype=torch.int32, device=alpha.device)
    for _ in range(iters):
        # Levenberg-style floor keeps the 3×3 solvable off-rank
        lam = 1e-6 * (h_b[(0, 0)] + h_b[(1, 1)] + h_b[(2, 2)]) + _TINY
        h_d = dict(h_b)
        for j in range(3):
            h_d[(j, j)] = h_b[(j, j)] + lam
        (d0, d1, d2), ok3 = _solve3(h_d, g_b)
        step = torch.stack([d0, d1, d2], -1)
        nrm = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
        scale = torch.clamp(trust[..., None] / torch.clamp(nrm, min=_TINY), max=1.0)
        step = torch.where(ok3[..., None], step * scale, torch.zeros_like(step))
        alpha_n = torch.minimum(torch.maximum(alpha + step, lo_a), hi_a)
        chi2_n, g_n, h_n, kd_n, ks_n = eval_at(alpha_n)
        okn = (chi2_n < chi2_b) & torch.isfinite(chi2_n)
        alpha = torch.where(okn[..., None], alpha_n, alpha)
        chi2_b = torch.where(okn, chi2_n, chi2_b)
        g_b = [torch.where(okn, g_n[j], g_b[j]) for j in range(3)]
        h_b = {k: torch.where(okn, h_n[k], h_b[k]) for k in h_b}
        kd_b = torch.where(okn[..., None], kd_n, kd_b)
        ks_b = torch.where(okn[..., None], ks_n, ks_b)
        trust = torch.where(okn, torch.clamp(trust * 2.0, max=span), trust * 0.25)
        n_acc = n_acc + okn.to(torch.int32)

    sig = torch.exp(alpha[..., 0]) if use_log else alpha[..., 0]
    p = torch.cat([kd_b, ks_b, sig[..., None], alpha[..., 1:2], alpha[..., 2:3]], dim=-1).to(dtype)
    converged = trust < 1e-6 * span
    g_inf = torch.maximum(torch.maximum(torch.abs(g_b[0]), torch.abs(g_b[1])), torch.abs(g_b[2]))
    return JointVarProResult(
        p=p, chi2=torch.clamp(chi2_b, min=0.0), iters=n_acc,
        stop=torch.where(converged, 2, 3).to(torch.int32), g_inf=g_inf,
    )
