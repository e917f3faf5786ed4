"""The reference fits, in plain torch and in any float dtype.

Both minimise the configuration's weighted least squares
``Σ (w·(f(p) − y))²`` in its box, then run its IRLS rounds: each round's
weights are the base weights times √ψ(r)/r of the last round's residuals,
with the per-(texel, channel) scale 1.4826 · median|r| over the views of
positive weight (the upper median, floored at 1e-3), as the program
documents (``solver/robust.py``). The first round starts from a grid, each later round
from the last round's parameters:

- per texel and channel, a (kd, ks, shape) lobe: a dense grid over the shape
  with the exact box-constrained (kd, ks) at each point, then Levenberg–
  Marquardt from the grid's best point;
- the joint normal map, (kd_rgb, ks_rgb, roughness, nu, nv) a face: a grid
  over (roughness, nu, nv) with each channel's exact (kd, ks), then LM on
  all nine.

The LM takes forward-mode Jacobians (``torch.func.jvp``) and projects each
step into the box; the damped normal equations are solved by a Cholesky
factorisation written out in the working dtype, so a bfloat16 run computes
in bfloat16 throughout.
"""

from __future__ import annotations

import math

import torch
from torch.func import jvp

from gpubench.reference import lobes

HUBER = 1.345
MAD_TO_SIGMA = 1.4826
SHAPE_GRIDS = {
    "blinn_phong": lambda: torch.logspace(math.log10(0.5), 2.0, 64, dtype=torch.float64),
    "cook_torrance": lambda: torch.linspace(0.02, 1.0, 50, dtype=torch.float64),
}


def box_ls2(a, b, y, w, lo, hi):
    """The (kd, ks) in [lo0, hi0] × [lo1, hi1] that minimise
    Σ_V (w·(kd·a + ks·b − y))², exactly: the interior solution if it is
    feasible, else the best of the four edges. → kd, ks, objective."""
    lo, hi = [float(x) for x in lo], [float(x) for x in hi]
    wa, wb, wy = w * a, w * b, w * y
    saa, sab, sbb = (wa * wa).sum(-1), (wa * wb).sum(-1), (wb * wb).sum(-1)
    say, sby, syy = (wa * wy).sum(-1), (wb * wy).sum(-1), (wy * wy).sum(-1)
    tiny = torch.finfo(saa.dtype).tiny

    def obj(kd, ks):
        return syy - 2 * kd * say - 2 * ks * sby + kd * kd * saa + 2 * kd * ks * sab + ks * ks * sbb

    det = saa * sbb - sab * sab
    safe = torch.where(det.abs() > tiny, det, torch.ones_like(det))
    kd_i, ks_i = (sbb * say - sab * sby) / safe, (saa * sby - sab * say) / safe
    inside = (det.abs() > tiny) & (kd_i >= lo[0]) & (kd_i <= hi[0]) & (ks_i >= lo[1]) & (ks_i <= hi[1])
    best_kd, best_ks = kd_i, ks_i
    best = torch.where(inside, obj(kd_i, ks_i), torch.full_like(det, float("inf")))
    sbb_s = torch.clamp(sbb, min=tiny)
    saa_s = torch.clamp(saa, min=tiny)
    for kd in (lo[0], hi[0]):
        kd_t = torch.full_like(det, kd)
        ks_t = torch.clamp((sby - kd * sab) / sbb_s, lo[1], hi[1])
        o = obj(kd_t, ks_t)
        take = o < best
        best, best_kd, best_ks = torch.where(take, o, best), torch.where(take, kd_t, best_kd), \
            torch.where(take, ks_t, best_ks)
    for ks in (lo[1], hi[1]):
        ks_t = torch.full_like(det, ks)
        kd_t = torch.clamp((say - ks * sab) / saa_s, lo[0], hi[0])
        o = obj(kd_t, ks_t)
        take = o < best
        best, best_kd, best_ks = torch.where(take, o, best), torch.where(take, kd_t, best_kd), \
            torch.where(take, ks_t, best_ks)
    return best_kd, best_ks, best


def spd_solve(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve a x = g for symmetric positive definite (..., m, m) ``a`` by
    Cholesky, in ``a``'s dtype."""
    m = a.shape[-1]
    low = torch.zeros_like(a)
    for j in range(m):
        d = a[..., j, j] - (low[..., j, :j] ** 2).sum(-1)
        low[..., j, j] = torch.sqrt(torch.clamp(d, min=torch.finfo(a.dtype).tiny))
        for i in range(j + 1, m):
            low[..., i, j] = (a[..., i, j] - (low[..., i, :j] * low[..., j, :j]).sum(-1)) \
                / low[..., j, j]
    z = torch.zeros_like(g)
    for i in range(m):
        z[..., i] = (g[..., i] - (low[..., i, :i] * z[..., :i]).sum(-1)) / low[..., i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(m)):
        x[..., i] = (z[..., i] - (low[..., i + 1:, i] * x[..., i + 1:]).sum(-1)) / low[..., i, i]
    return x


def lm(residual, p, lo, hi, iters: int):
    """Box-projected Levenberg–Marquardt on a batch: ``residual(p (B, m)) →
    (B, N)``. A step is taken where it lowers the sum of squares."""
    m = p.shape[-1]
    eye = torch.eye(m, dtype=p.dtype, device=p.device)
    r = residual(p)
    f = (r * r).sum(-1)
    mu = None
    for _ in range(iters):
        cols = [jvp(residual, (p,), (eye[j].expand_as(p),))[1] for j in range(m)]
        jac = torch.stack(cols, -1)                                     # (B, N, m)
        a = jac.transpose(-1, -2) @ jac
        g = (jac * r[..., None]).sum(-2)
        diag = torch.diagonal(a, dim1=-2, dim2=-1)
        if mu is None:
            mu = 1e-3 * diag.amax(-1)
        damped = a + (mu[..., None] * torch.clamp(diag, min=1e-12))[..., None] * eye
        p_new = torch.minimum(torch.maximum(p - spd_solve(damped, g), lo), hi)
        r_new = residual(p_new)
        f_new = (r_new * r_new).sum(-1)
        take = f_new < f
        p = torch.where(take[..., None], p_new, p)
        r = torch.where(take[..., None], r_new, r)
        f = torch.where(take, f_new, f)
        mu = torch.where(take, mu / 3.0, mu * 4.0)
    return p


def robust_weights(resid, base):
    """Huber IRLS weights over the last (view) axis, composed with ``base``."""
    r = resid.abs()
    srt = torch.sort(torch.where(base > 0, r, torch.full_like(r, float("inf"))), -1).values
    idx = (base > 0).sum(-1) // 2
    med = torch.gather(srt, -1, idx[..., None])[..., 0]
    med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
    sigma = torch.clamp(MAD_TO_SIGMA * med, min=1e-3)
    u = r / (HUBER * sigma[..., None])
    w = torch.where(u <= 1.0, torch.ones_like(u), 1.0 / torch.clamp(u, min=1e-12))
    return base * torch.sqrt(w)


def texel_model(model: str, c: dict, p: torch.Tensor) -> torch.Tensor:
    """p (T, C, 3) → predictions (T, C, V) for cosines (T, V)."""
    cc = {k: v[:, None, :] for k, v in c.items()}
    return lobes.LOBES[model](p[..., 0:1], p[..., 1:2], p[..., 2:3], cc)


def fit_texels(model: str, c: dict, y, w, lower, upper, rounds: int, lm_iters: int = 40):
    """Per texel and channel: y, w (T, C, V), cosines (T, V) → p (T, C, 3)
    and its χ² (T, C) under the last round's weights."""
    dt, dev = y.dtype, y.device
    lo = torch.tensor(lower, dtype=dt, device=dev)
    hi = torch.tensor(upper, dtype=dt, device=dev)
    grid = SHAPE_GRIDS[model]().to(dev, dt)
    grid = grid[(grid >= lo[2]) & (grid <= hi[2])]
    lobe = lobes.LOBES[model]
    cc = {k: v[:, None, :] for k, v in c.items()}
    one, zero = torch.ones((), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev)
    t, nc = y.shape[:2]
    wk = w
    p = None
    for r in range(rounds + 1):
        if r == 0:
            best = torch.full((t, nc), float("inf"), dtype=dt, device=dev)
            p = torch.zeros((t, nc, 3), dtype=dt, device=dev)
            for s in grid:
                a = lobe(one, zero, s, cc)
                b = lobe(zero, one, s, cc)
                kd, ks, o = box_ls2(a, b, y, wk, lo, hi)
                take = o < best
                best = torch.where(take, o, best)
                p = torch.where(take[..., None],
                                torch.stack([kd, ks, torch.full_like(kd, float(s))], -1), p)
        w_flat, y_flat = wk.reshape(t * nc, -1), y.reshape(t * nc, -1)
        c_rep = {k: v.repeat_interleave(nc, 0) for k, v in c.items()}

        def residual(q):
            return (lobe(q[:, 0:1], q[:, 1:2], q[:, 2:3], c_rep) - y_flat) * w_flat

        p = lm(residual, p.reshape(t * nc, 3), lo, hi, lm_iters).reshape(t, nc, 3)
        if r < rounds:
            wk = robust_weights(texel_model(model, c, p) - y, w)
    return p, ((wk * (texel_model(model, c, p) - y)) ** 2).sum(-1)


def joint_model(model: str, normals, l, v, p):
    """p (T, 9) [kd_rgb, ks_rgb, shape, nu, nv] → predictions (T, 3, V) for
    unit normals (T, 3) and unit directions l, v (T, V, 3)."""
    n = lobes.tilted(normals, p[:, 7], p[:, 8])
    c = lobes.cosines_of(n, l, v)
    cc = {k: x[:, None, :] for k, x in c.items()}
    return lobes.LOBES[model](p[:, 0:3, None], p[:, 3:6, None], p[:, 6:7, None], cc)


def _joint_grid(lobe, normals, l, v, y, w, lo, hi, tilts, shapes, block: int):
    """The best (roughness, nu, nv) of the grid for each face, with each
    channel's exact (kd, ks) there."""
    dt, dev = y.dtype, y.device
    one, zero = torch.ones((), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev)
    parts = []
    for s0 in range(0, len(y), block):
        sl = slice(s0, min(s0 + block, len(y)))
        n_sl = sl.stop - sl.start
        best = torch.full((n_sl,), float("inf"), dtype=dt, device=dev)
        pb = torch.zeros((n_sl, 9), dtype=dt, device=dev)
        for nu in tilts:
            for nv in tilts:
                n = lobes.tilted(normals[sl], nu.expand(n_sl), nv.expand(n_sl))
                c = {k: x[:, None, :] for k, x in lobes.cosines_of(n, l[sl], v[sl]).items()}
                a = lobe(one, zero, shapes[0], c)
                for s in shapes:
                    kd, ks, o = box_ls2(a, lobe(zero, one, s, c), y[sl], w[sl],
                                        lo[[0, 3]], hi[[0, 3]])
                    tot = o.sum(-1)
                    take = tot < best
                    best = torch.where(take, tot, best)
                    rest = torch.stack([s.expand_as(tot), nu.expand_as(tot), nv.expand_as(tot)], -1)
                    pb = torch.where(take[:, None], torch.cat([kd, ks, rest], -1), pb)
        parts.append(pb)
    return torch.cat(parts)


def fit_joint(model: str, normals, l, v, y, w, lower, upper, rounds: int,
              tilt_steps: int = 9, shape_steps: int = 12, lm_iters: int = 60, block: int = 16384):
    """The joint normal map: y, w (T, 3, V) → p (T, 9) and its χ² (T,)
    under the last round's weights."""
    dt, dev = y.dtype, y.device
    lo = torch.tensor(lower, dtype=dt, device=dev)
    hi = torch.tensor(upper, dtype=dt, device=dev)
    tilts = torch.linspace(float(lo[7]), float(hi[7]), tilt_steps, dtype=dt, device=dev)
    shapes = torch.linspace(max(float(lo[6]), 0.05), float(hi[6]), shape_steps, dtype=dt,
                            device=dev)
    t = y.shape[0]
    wk = w
    p = _joint_grid(lobes.LOBES[model], normals, l, v, y, w, lo, hi, tilts, shapes, block)
    for r in range(rounds + 1):
        def residual(q):
            return ((joint_model(model, normals, l, v, q) - y) * wk).reshape(t, -1)

        p = lm(residual, p, lo, hi, lm_iters)
        if r < rounds:
            wk = robust_weights(joint_model(model, normals, l, v, p) - y, w)
    return p, residual(p).pow(2).sum(-1)
