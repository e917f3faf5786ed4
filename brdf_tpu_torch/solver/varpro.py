"""Variable-projection (VarPro) solver for separable lobe fits, unfused tier.

Port of ``brdf_tpu/solver/varpro.py``. Each separable lobe is ``I = kd·a + ks·b(shape)``; the linear pair
is eliminated in closed form by :func:`_bvls2` and the profiled objective is
minimised by a safeguarded Newton iteration with Kaufman's projected
curvature and a trust-clipped accept-if-better step:

- :func:`varpro_fit`, the m=3 lobes: 1-D Newton in log σ (exponent) or σ
  (roughness). The fused kernel K1 (``ops/varpro.py``) shares :func:`_bvls2`
  and the same Newton; this tier differs only in its default init
  (``linear_grid_init(refine=True)``) and in evaluating ∂b/∂σ by a JVP.
- :func:`varpro_fit_nd`, the m=4 and m=5 lobes: d-D Newton over the shape
  vector with the closed-form damped solve :func:`_solve_damped_sym`; the
  fused kernel K8 (``ops/varpro_nd.py``) runs the same math.
- :func:`varpro_fit_fresnel_lin`, ``cook_torrance_fresnel`` with both
  Fresnel scale directions profiled out by the 3-variable NNLS
  :func:`_nnls3`, leaving 1-D Newton over the roughness.

Each takes ``axis_name``: the axis of the current mesh
(``parallel/mesh.py::use_mesh``) over which the view axis is sharded. Every
view sum (Gram entries, χ², φ', curvature) is then an ``axis_sum`` of the
ranks' partial sums, as the JAX package ``psum``s them, and so is the grid
init's when the fit makes its own start.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.parallel.mesh import axis_sum
from brdf_tpu_torch.solver.init import linear_grid_init

_TINY = 1e-30


def _view_sum(axis_name):
    """Σ over the last (view) axis, across the ranks of ``axis_name``."""
    return lambda x: axis_sum(torch.sum(x, -1), axis_name)

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
    axis_name: str | None = None,
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
    rsum = _view_sum(axis_name)

    if p0 is None:
        p0 = linear_grid_init(model, angles, target, weights=w, refine=True,
                              axis_name=axis_name)
    sigma0 = torch.clamp(p0[..., 2], sig_floor, float(hi[2]))
    t0 = torch.log(sigma0) if use_log else sigma0

    # the residual is formed directly, never by the Gram identity, whose f32
    # cancellation would floor χ² and break the accept test
    yw = target * w
    mid = torch.tensor([1.0, 0.0, lo[2] + 0.5 * (hi[2] - lo[2])], dtype=dtype,
                       device=target.device)
    aw = spec.fn(mid, angles) * w
    aa = rsum(aw * aw)
    ay = rsum(aw * yw)
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
        ab = rsum(aw * bw)
        bb = rsum(bw * bw)
        by = rsum(bw * yw)
        kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
        rw = yw - kd[..., None] * aw - ks[..., None] * bw
        chi2 = rsum(rw * rw)
        g = -2.0 * ks * rsum(rw * dbw)
        a_db = rsum(aw * dbw)
        b_db = rsum(bw * dbw)
        det = aa * bb - ab * ab
        det_ok = det > _TINY
        det_s = torch.where(det_ok, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        x1 = torch.where(det_ok, (bb * a_db - ab * b_db) / det_s, zero)
        x2 = torch.where(det_ok, (aa * b_db - ab * a_db) / det_s, zero)
        proj = rsum(dbw * dbw) - x1 * a_db - x2 * b_db
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


# multi-dimensional-shape separable lobes → per-dimension floor of the shape
# box's lower edge: roughness-like dimensions are floored at the 1e-3 the
# lobes themselves clamp at; −inf means no floor (the signed φ and f0 keep
# their box's own lower edge)
_SEPARABLE_ND = {
    "cook_torrance_fresnel": (1e-3, -np.inf),          # (rough, f0)
    "ward_aniso": (1e-3, 1e-3, -np.inf),               # (alpha_x, alpha_y, phi)
    "cook_torrance_aniso": (1e-3, 1e-3, -np.inf),      # (rough_x, rough_y, phi)
}


def _solve_damped_sym(h, g, d, lam):
    """Batched damped symmetric solve ``step = −(H + λI)⁻¹ g`` for d ≤ 3.

    ``h`` maps the upper triangle (j, k) to entries; closed form (d=1 scalar,
    d=2 2×2, d=3 Cramer with cofactors). Returns (step list, solvable mask)."""
    hd = dict(h)
    for j in range(d):
        hd[(j, j)] = h[(j, j)] + lam
    if d == 1:
        ok = hd[(0, 0)] > _TINY
        return [-g[0] / torch.where(ok, hd[(0, 0)], torch.ones_like(hd[(0, 0)]))], ok
    if d == 2:
        det = hd[(0, 0)] * hd[(1, 1)] - hd[(0, 1)] * hd[(0, 1)]
        ok = torch.abs(det) > _TINY
        det_s = torch.where(ok, det, torch.ones_like(det))
        s0 = -(hd[(1, 1)] * g[0] - hd[(0, 1)] * g[1]) / det_s
        s1 = -(hd[(0, 0)] * g[1] - hd[(0, 1)] * g[0]) / det_s
        return [s0, s1], ok
    c00 = hd[(1, 1)] * hd[(2, 2)] - hd[(1, 2)] * hd[(1, 2)]
    c01 = hd[(0, 2)] * hd[(1, 2)] - hd[(0, 1)] * hd[(2, 2)]
    c02 = hd[(0, 1)] * hd[(1, 2)] - hd[(0, 2)] * hd[(1, 1)]
    c11 = hd[(0, 0)] * hd[(2, 2)] - hd[(0, 2)] * hd[(0, 2)]
    c12 = hd[(0, 1)] * hd[(0, 2)] - hd[(0, 0)] * hd[(1, 2)]
    c22 = hd[(0, 0)] * hd[(1, 1)] - hd[(0, 1)] * hd[(0, 1)]
    det = hd[(0, 0)] * c00 + hd[(0, 1)] * c01 + hd[(0, 2)] * c02
    ok = torch.abs(det) > _TINY
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    s0 = -(c00 * g[0] + c01 * g[1] + c02 * g[2]) * inv
    s1 = -(c01 * g[0] + c11 * g[1] + c12 * g[2]) * inv
    s2 = -(c02 * g[0] + c12 * g[1] + c22 * g[2]) * inv
    return [s0, s1, s2], ok


def shape_box(model: str, lo, hi) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """The d-D shape box of a ``_SEPARABLE_ND`` lobe: the model box's shape
    dimensions with each lower edge raised to its floor."""
    floors = _SEPARABLE_ND[model]
    d = len(floors)
    lo_s = tuple(max(float(lo[2 + j]), floors[j]) for j in range(d))
    hi_s = tuple(float(hi[2 + j]) for j in range(d))
    return lo_s, hi_s


def varpro_fit_nd(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,          # (T, V)
    weights: torch.Tensor | None = None,
    p0: torch.Tensor | None = None,   # (T, m) optional start (else grid init)
    iters: int = 10,
    lower: tuple | None = None,
    upper: tuple | None = None,
    axis_name: str | None = None,
) -> VarProResult:
    """Variable projection for separable lobes with a d-dimensional shape
    space (``I = kd·a + ks·b(shape)``, d = n_params − 2): 2-D Newton over
    (roughness, f0) for ``cook_torrance_fresnel``, 3-D over (α_x, α_y, φ)
    for ``ward_aniso`` and ``cook_torrance_aniso``.

    Per iteration: one basis evaluation and d JVPs, the exact 2-D
    box-constrained solve for (kd, ks), Kaufman-projected d×d Gauss-Newton
    (:func:`_solve_damped_sym`) and a trust-clipped accept-if-better step.
    """
    if model not in _SEPARABLE_ND:
        raise ValueError(f"varpro_fit_nd supports {sorted(_SEPARABLE_ND)}, got {model!r}")
    spec = MODELS[model]
    d = spec.n_params - 2
    dtype = target.dtype
    dev = target.device
    lo = np.asarray(spec.lower if lower is None else lower, np.float64)
    hi = np.asarray(spec.upper if upper is None else upper, np.float64)
    if weights is None:
        weights = torch.ones_like(target)
    w = weights.to(dtype)
    yw = target * w
    rsum = _view_sum(axis_name)

    lo_s_t, hi_s_t = shape_box(model, lo, hi)
    lo_s_np, hi_s_np = np.asarray(lo_s_t), np.asarray(hi_s_t)
    span = float(np.linalg.norm(hi_s_np - lo_s_np))
    lo_s = torch.tensor(lo_s_np, dtype=dtype, device=dev)
    hi_s = torch.tensor(hi_s_np, dtype=dtype, device=dev)

    if p0 is None:
        p0 = linear_grid_init(model, angles, target, weights=weights, axis_name=axis_name)
    shape0 = torch.minimum(torch.maximum(p0[..., 2:2 + d].to(dtype), lo_s), hi_s)   # (T, d)

    # diffuse basis kd·cos_ln: shape-independent (mid-box shape values)
    mid = tuple(0.5 * (lo_s_np[j] + hi_s_np[j]) for j in range(d))
    aw = spec.fn(torch.tensor((1.0, 0.0) + mid, dtype=dtype, device=dev), angles) * w
    aa = rsum(aw * aw)
    ay = rsum(aw * yw)
    l0, u0, l1, u1 = float(lo[0]), float(hi[0]), float(lo[1]), float(hi[1])

    def basis_b(shape):
        p = torch.cat([torch.zeros_like(shape[..., :1]), torch.ones_like(shape[..., :1]), shape], -1)
        return spec.fn(p, angles)

    def eval_at(shape):
        b = basis_b(shape)
        tangents = []
        for j in range(d):
            e = torch.zeros_like(shape)
            e[..., j] = 1.0
            tangents.append(torch.func.jvp(basis_b, (shape,), (e,))[1])
        bw = b * w
        ab = rsum(aw * bw)
        bb = rsum(bw * bw)
        by = rsum(bw * yw)
        kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
        rw = yw - kd[..., None] * aw - ks[..., None] * bw
        chi2 = rsum(rw * rw)
        det = aa * bb - ab * ab
        det_ok = det > 1e-30
        det_s = torch.where(det_ok, det, torch.ones_like(det))
        zero = torch.zeros_like(det)

        def project(u):
            # Kaufman: only the component of ks·∂b ⊥ span{a, b} bends the
            # profiled objective (the linear pair re-solves as the shape moves)
            ua = rsum(u * aw)
            ub = rsum(u * bw)
            x1 = torch.where(det_ok, (bb * ua - ab * ub) / det_s, zero)
            x2 = torch.where(det_ok, (aa * ub - ab * ua) / det_s, zero)
            return u - x1[..., None] * aw - x2[..., None] * bw

        g, cols = [], []
        for j in range(d):
            u = ks[..., None] * tangents[j] * w
            g.append(-2.0 * rsum(rw * u))
            cols.append(project(u))
        h = {(j, k): 2.0 * rsum(cols[j] * cols[k]) for j in range(d) for k in range(j, d)}
        return chi2, g, h, kd, ks

    shape = shape0
    chi2_b, g_b, h_b, kd_b, ks_b = eval_at(shape)
    trust = torch.full(shape0.shape[:-1], 0.25 * span, dtype=dtype, device=dev)
    n_acc = torch.zeros(shape0.shape[:-1], dtype=torch.int32, device=dev)
    for _ in range(iters):
        lam = 1e-6 * sum(h_b[(j, j)] for j in range(d)) + _TINY
        steps, ok_h = _solve_damped_sym(h_b, g_b, d, lam)
        step = torch.stack(steps, -1)
        nrm = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
        step = torch.where(
            ok_h[..., None],
            step * torch.clamp(trust[..., None] / torch.clamp(nrm, min=_TINY), max=1.0),
            torch.zeros_like(step),
        )
        shape_n = torch.minimum(torch.maximum(shape + step, lo_s), hi_s)
        chi2_n, g_n, h_n, kd_n, ks_n = eval_at(shape_n)
        ok = (chi2_n < chi2_b) & torch.isfinite(chi2_n)
        shape = torch.where(ok[..., None], shape_n, shape)
        chi2_b = torch.where(ok, chi2_n, chi2_b)
        g_b = [torch.where(ok, g_n[j], g_b[j]) for j in range(d)]
        h_b = {k: torch.where(ok, h_n[k], h_b[k]) for k in h_b}
        kd_b = torch.where(ok, kd_n, kd_b)
        ks_b = torch.where(ok, ks_n, ks_b)
        trust = torch.where(ok, torch.clamp(trust * 2.0, max=span), trust * 0.25)
        n_acc = n_acc + ok.to(torch.int32)

    g_inf = torch.abs(g_b[0])
    for j in range(1, d):
        g_inf = torch.maximum(g_inf, torch.abs(g_b[j]))
    return VarProResult(
        p=torch.cat([kd_b[..., None], ks_b[..., None], shape], -1).to(dtype),
        chi2=torch.clamp(chi2_b, min=0.0), iters=n_acc,
        stop=torch.where(trust < 1e-6 * span, 2, 3).to(torch.int32), g_abs=g_inf,
    )


def varpro_fit_fresnel(
    angles: ShadingAngles,
    target: torch.Tensor,          # (T, V)
    weights: torch.Tensor | None = None,
    p0: torch.Tensor | None = None,   # (T, 4) optional start (else grid init)
    iters: int = 10,
    lower: tuple | None = None,
    upper: tuple | None = None,
    axis_name: str | None = None,
) -> VarProResult:
    """2-D profiled Newton over (roughness, f0) for ``cook_torrance_fresnel``:
    :func:`varpro_fit_nd`'s d=2 instance under its own name. The ks·F(f0)
    product couples the two specular scales, which
    :func:`varpro_fit_fresnel_lin` removes exactly."""
    return varpro_fit_nd("cook_torrance_fresnel", angles, target, weights=weights, p0=p0,
                         iters=iters, lower=lower, upper=upper, axis_name=axis_name)


def _nnls3(g00, g01, g02, g11, g12, g22, r0, r1, r2):
    """Exact 3-variable nonnegative least squares from Gram entries,
    ``min ‖x₀A + x₁B + x₂C − y‖²  s.t.  x ≥ 0``, elementwise.

    The optimal active set is one of the 8 subsets of variables held at 0:
    all are enumerated (3×3 Cramer interior, three 2×2 faces, three 1-D
    edges, the origin), the feasible ones kept and the cheapest taken, ties
    to the earlier candidate. The cost is xᵀGx − 2xᵀr (yᵀy dropped)."""
    big = torch.full_like(g00, float("inf"))
    z = torch.zeros_like(g00)
    one = torch.ones_like(g00)

    def cost(x0, x1, x2):
        return (x0 * x0 * g00 + x1 * x1 * g11 + x2 * x2 * g22
                + 2.0 * (x0 * x1 * g01 + x0 * x2 * g02 + x1 * x2 * g12)
                - 2.0 * (x0 * r0 + x1 * r1 + x2 * r2))

    cands = []
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    ok3 = torch.abs(det) > _TINY
    inv = torch.where(ok3, 1.0 / torch.where(ok3, det, one), z)
    xi0 = (c00 * r0 + c01 * r1 + c02 * r2) * inv
    xi1 = (c01 * r0 + c11 * r1 + c12 * r2) * inv
    xi2 = (c02 * r0 + c12 * r1 + c22 * r2) * inv
    cands.append((xi0, xi1, xi2, ok3 & (xi0 >= 0) & (xi1 >= 0) & (xi2 >= 0)))

    def face2(paa, pab, pbb, pra, prb):
        """2×2 unconstrained solve on a face (third variable at 0)."""
        dd = paa * pbb - pab * pab
        ok = torch.abs(dd) > _TINY
        dd_s = torch.where(ok, dd, one)
        xa = (pbb * pra - pab * prb) / dd_s
        xb = (paa * prb - pab * pra) / dd_s
        return xa, xb, ok & (xa >= 0) & (xb >= 0)

    xa, xb, okf = face2(g00, g01, g11, r0, r1)      # x2 = 0
    cands.append((xa, xb, z, okf))
    xa, xb, okf = face2(g00, g02, g22, r0, r2)      # x1 = 0
    cands.append((xa, z, xb, okf))
    xa, xb, okf = face2(g11, g12, g22, r1, r2)      # x0 = 0
    cands.append((z, xa, xb, okf))

    def edge1(pg, pr):
        return torch.clamp(pr / torch.clamp(pg, min=_TINY), min=0.0)

    every = torch.ones_like(ok3)
    cands.append((edge1(g00, r0), z, z, every))
    cands.append((z, edge1(g11, r1), z, every))
    cands.append((z, z, edge1(g22, r2), every))
    cands.append((z, z, z, every))                  # the origin is always feasible

    best = (z, z, z)
    best_c = big
    for x0, x1, x2, ok in cands:
        c = torch.where(ok, cost(x0, x1, x2), big)
        take = c < best_c
        best = tuple(torch.where(take, xn, bn) for xn, bn in zip((x0, x1, x2), best))
        best_c = torch.where(take, c, best_c)
    return best


def varpro_fit_fresnel_lin(
    angles: ShadingAngles,
    target: torch.Tensor,          # (T, V)
    weights: torch.Tensor | None = None,
    p0: torch.Tensor | None = None,   # (T, 4) optional start (else grid init)
    iters: int = 8,
    grid_points: int = 8,
    lower: tuple | None = None,
    upper: tuple | None = None,
    axis_name: str | None = None,
) -> VarProResult:
    """Scale-profiled VarPro for ``cook_torrance_fresnel``.

    Schlick's Fresnel is affine in f0, so the lobe decomposes as
    ``I = kd·a + s·b₀(ρ) + q·b₁(ρ)`` with ``s = ks·f0``, ``q = ks·(1−f0)``,
    ``b₀`` the lobe at f0 = 1 and ``b₁`` at f0 = 0, both functions of the
    roughness ρ alone. The ks·F(f0) direction is then linear and eliminated
    in closed form by the 3-variable NNLS :func:`_nnls3` at each
    evaluation; ρ takes a grid (one NNLS per point) and then 1-D Newton with
    the Kaufman projection against span{a, b₀, b₁}. Returned: ``ks = s + q``
    and ``f0 = s/(s+q)``, or the f0 box midpoint where there is no specular
    energy; ks and f0 are clamped to the box at the end. A caller ``p0``
    skips the grid: only its roughness carries state.
    """
    spec = MODELS["cook_torrance_fresnel"]
    dtype = target.dtype
    dev = target.device
    lo = np.asarray(spec.lower if lower is None else lower, np.float64)
    hi = np.asarray(spec.upper if upper is None else upper, np.float64)
    if weights is None:
        weights = torch.ones_like(target)
    w = weights.to(dtype)
    yw = target * w

    s_lo = float(max(lo[2], 1e-3))
    s_hi = float(hi[2])
    span = s_hi - s_lo
    rsum = _view_sum(axis_name)

    aw = spec.fn(torch.tensor([1.0, 0.0, 0.5, 0.5], dtype=dtype, device=dev), angles) * w
    g00 = rsum(aw * aw)
    r0 = rsum(aw * yw)

    def bases(rho):
        """ρ (T,) → (b₀, b₁), each (T, V): the specular lobe at f0 = 1 (F ≡ 1)
        and at f0 = 0 (F = (1 − vh)⁵)."""
        zero = torch.zeros_like(rho)
        one = torch.ones_like(rho)
        return (spec.fn(torch.stack([zero, one, rho, one], -1), angles),
                spec.fn(torch.stack([zero, one, rho, zero], -1), angles))

    def profile(rho):
        """The 3-variable NNLS at roughness ρ → (χ², kd, s, q, cached rows)."""
        b0, b1 = bases(rho)
        b0w = b0 * w
        b1w = b1 * w
        g01 = rsum(aw * b0w)
        g02 = rsum(aw * b1w)
        g11 = rsum(b0w * b0w)
        g12 = rsum(b0w * b1w)
        g22 = rsum(b1w * b1w)
        r1 = rsum(b0w * yw)
        r2 = rsum(b1w * yw)
        kd, s, q = _nnls3(g00, g01, g02, g11, g12, g22, r0, r1, r2)
        kd = torch.clamp(kd, float(lo[0]), float(hi[0]))
        rw = yw - kd[..., None] * aw - s[..., None] * b0w - q[..., None] * b1w
        chi2 = rsum(rw * rw)
        return chi2, kd, s, q, (b0w, b1w, rw, g01, g02, g11, g12, g22)

    def eval_at(rho):
        """The profile, the envelope-theorem φ' and the projected curvature."""
        chi2, kd, s, q, (b0w, b1w, rw, g01, g02, g11, g12, g22) = profile(rho)

        def sb(r_var):
            b0_, b1_ = bases(r_var)
            return s[..., None] * b0_ + q[..., None] * b1_

        du = torch.func.jvp(sb, (rho,), (torch.ones_like(rho),))[1]
        uw = du * w
        g = -2.0 * rsum(rw * uw)
        ua = rsum(uw * aw)
        ub0 = rsum(uw * b0w)
        ub1 = rsum(uw * b1w)
        # the in-span component's coefficients c solve G c = t, t = (ua, ub0,
        # ub1); _solve_damped_sym returns −(G + λ)⁻¹·arg, so it gets −t.
        # ‖P⊥ u‖² = ‖u‖² − cᵀt
        c0, c1, c2 = _solve_damped_sym(
            {(0, 0): g00, (0, 1): g01, (0, 2): g02, (1, 1): g11, (1, 2): g12, (2, 2): g22},
            [-ua, -ub0, -ub1], 3, 1e-7 * (g00 + g11 + g22) + _TINY,
        )[0]
        proj2 = rsum(uw * uw) - (c0 * ua + c1 * ub0 + c2 * ub1)
        h = 2.0 * torch.clamp(proj2, min=0.0)
        return chi2, g, h, kd, s, q

    t_shape = target.shape[:-1]
    if p0 is not None:
        best_rho = torch.clamp(p0[..., 2].to(dtype), s_lo, s_hi)
    else:
        grid = np.linspace(max(0.03, s_lo), s_hi, int(grid_points))
        best_rho = torch.full(t_shape, float(grid[0]), dtype=dtype, device=dev)
        best_chi2 = torch.full(t_shape, float("inf"), dtype=dtype, device=dev)
        for gval in grid:
            rho_g = torch.full(t_shape, float(gval), dtype=dtype, device=dev)
            chi2_g = profile(rho_g)[0]
            better = chi2_g < best_chi2
            best_rho = torch.where(better, rho_g, best_rho)
            best_chi2 = torch.where(better, chi2_g, best_chi2)

    rho = best_rho
    chi2_b, g_b, h_b, kd_b, s_b, q_b = eval_at(rho)
    trust = torch.full(t_shape, 0.25 * span, dtype=dtype, device=dev)
    n_acc = torch.zeros(t_shape, dtype=torch.int32, device=dev)
    for _ in range(iters):
        step = torch.minimum(torch.maximum(-g_b / torch.clamp(h_b, min=_TINY), -trust), trust)
        rho_n = torch.clamp(rho + step, s_lo, s_hi)
        chi2_n, g_n, h_n, kd_n, s_n, q_n = eval_at(rho_n)
        ok = (chi2_n < chi2_b) & torch.isfinite(chi2_n)
        rho = torch.where(ok, rho_n, rho)
        chi2_b = torch.where(ok, chi2_n, chi2_b)
        g_b = torch.where(ok, g_n, g_b)
        h_b = torch.where(ok, h_n, h_b)
        kd_b = torch.where(ok, kd_n, kd_b)
        s_b = torch.where(ok, s_n, s_b)
        q_b = torch.where(ok, q_n, q_b)
        trust = torch.where(ok, torch.clamp(trust * 2.0, max=span), trust * 0.25)
        n_acc = n_acc + ok.to(torch.int32)

    ks_f = s_b + q_b
    has_spec = ks_f > 1e-12
    f0_mid = 0.5 * float(lo[3] + hi[3])
    f0_f = torch.where(has_spec, s_b / torch.where(has_spec, ks_f, torch.ones_like(ks_f)),
                       torch.full_like(ks_f, f0_mid))
    ks_f = torch.clamp(ks_f, float(lo[1]), float(hi[1]))
    f0_f = torch.clamp(f0_f, float(lo[3]), float(hi[3]))
    return VarProResult(
        p=torch.stack([kd_b, ks_f, rho, f0_f], -1).to(dtype),
        chi2=torch.clamp(chi2_b, min=0.0), iters=n_acc,
        stop=torch.where(trust < 1e-6 * span, 2, 3).to(torch.int32), g_abs=torch.abs(g_b),
    )
