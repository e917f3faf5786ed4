"""The anisotropic Ward lobe of the ``timber-aniso-16led`` configuration and
its reference fit, in plain torch, in any float dtype (float64 for the
check, bfloat16 for the control). Imports nothing of the program; the
aniso scan generator renders with these.

The lobe is Ward's (G. J. Ward, "Measuring and Modeling Anisotropic
Reflection", SIGGRAPH 1992, eq. 5) as the program documents it
(``models/brdf.py::ward_aniso``), with parameters (kd, ks, alpha_x,
alpha_y, phi). Departures from the paper:

- the value is the radiance under a light of unit irradiance, so the BRDF
  is multiplied by ⟨N·L⟩:
  kd/π·⟨N·L⟩ + ks·√(⟨N·L⟩/N·V)·e^(−tan²δ(…))/(4π αx αy);
- the specular term lives only where N·L > 0, N·H > 0 and N·V > 0 (the lit
  mask), N·H is floored at 1e-4, N·V at 1e-12, each alpha at 1e-3;
- the surface's x and y directions are the normal's branchless tangent
  frame (Duff et al., ``lobes.tangent_frame``) turned by phi about the
  normal: (T·H, B·H) rotated by phi gives the half vector's components on
  the two axes of anisotropy, where the paper takes a fitted frame.

The reference fit, per texel and channel, minimises the weighted least
squares in the box: a dense grid over (alpha_x, alpha_y, phi) with the exact
box-constrained (kd, ks) at each point (``fit.box_ls2``), then box-projected
Levenberg–Marquardt on all five parameters (``fit.lm``), then the
configuration's IRLS rounds (``fit.robust_weights``), each later round from
the last round's parameters. The lobe is unchanged by (alpha_x, alpha_y, phi)
→ (alpha_y, alpha_x, phi ± π/2), so the grid's phi covers [0, π/2) alone.
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import fit as ref_fit
from gpubench.reference import lobes

EPS = 1e-12
# the grid: GRID_ALPHAS alphas a side, geometric from GRID_ALPHA_MIN (the
# box's floor of 1e-3 makes a lobe far narrower than the 16 views can tell
# apart) to the box's top; GRID_PHIS angles over the quarter turn
GRID_ALPHAS = 10
GRID_ALPHA_MIN = 0.02
GRID_PHIS = 6


def cosines(points, normals, eye, lights) -> dict:
    """points, normals (T, 3), eye (3,), lights (V, 3) → N·L, N·H, N·V, T·H
    and B·H, each (T, V), for the normal's tangent frame (T, B)."""
    l, v = lobes.directions(points, eye, lights)
    c = lobes.cosines_of(normals, l, v)
    h = lobes._unit(l + v)
    t, b = lobes.tangent_frame(normals)
    return dict(ln=c["ln"], nh=c["nh"], vn=c["vn"],
                th=(t[..., None, :] * h).sum(-1), bh=(b[..., None, :] * h).sum(-1))


def ward_aniso(kd, ks, ax, ay, phi, c: dict) -> torch.Tensor:
    """The lobe; parameters broadcast against the (..., V) cosines."""
    ax = torch.clamp(ax, min=1e-3)
    ay = torch.clamp(ay, min=1e-3)
    lit = (c["ln"] > 0) & (c["nh"] > 0) & (c["vn"] > 0)
    one = torch.ones_like(c["nh"])
    zero = torch.zeros_like(c["nh"])
    nl = torch.clamp(c["ln"], min=0.0)
    nv = torch.clamp(c["vn"], min=EPS)
    nh = torch.clamp(torch.where(lit, c["nh"], one), min=1e-4)
    cs, sn = torch.cos(phi), torch.sin(phi)
    ht = torch.where(lit, cs * c["th"] + sn * c["bh"], zero)
    hb = torch.where(lit, -sn * c["th"] + cs * c["bh"], zero)
    expo = ((ht / ax) ** 2 + (hb / ay) ** 2) / (nh * nh)
    lobe = torch.exp(-expo) / (4.0 * math.pi * ax * ay)
    spec = torch.where(lit, torch.sqrt(torch.where(lit, nl, one) / nv) * lobe, zero)
    return kd / math.pi * nl + ks * spec


def texel_model(c: dict, p: torch.Tensor) -> torch.Tensor:
    """p (T, C, 5) → predictions (T, C, V) for cosines (T, V)."""
    cc = {k: v[:, None, :] for k, v in c.items()}
    return ward_aniso(*(p[..., j:j + 1] for j in range(5)), cc)


def shape_grid(lo, hi, dtype, device) -> torch.Tensor:
    """(G, 3) points (alpha_x, alpha_y, phi) inside the box."""
    a_lo = max(float(lo[2]), float(lo[3]), GRID_ALPHA_MIN)
    a_hi = min(float(hi[2]), float(hi[3]))
    alphas = torch.logspace(math.log10(a_lo), math.log10(a_hi), GRID_ALPHAS, dtype=torch.float64)
    phis = torch.arange(GRID_PHIS, dtype=torch.float64) * (0.5 * math.pi / GRID_PHIS)
    phis = phis[(phis >= float(lo[4])) & (phis <= float(hi[4]))]
    g = torch.cartesian_prod(alphas, alphas, phis)
    return g.to(device, dtype)


def fit_texels(c: dict, y, w, lower, upper, rounds: int, lm_iters: int = 40):
    """Per texel and channel: y, w (T, C, V), cosines (T, V) → p (T, C, 5)
    and its χ² (T, C) under the last round's weights."""
    dt, dev = y.dtype, y.device
    lo = torch.tensor(lower, dtype=dt, device=dev)
    hi = torch.tensor(upper, dtype=dt, device=dev)
    cc = {k: v[:, None, :] for k, v in c.items()}
    one, zero = torch.ones((), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev)
    t, nc = y.shape[:2]
    a = ward_aniso(one, zero, one, one, zero, cc)
    best = torch.full((t, nc), float("inf"), dtype=dt, device=dev)
    p = torch.zeros((t, nc, 5), dtype=dt, device=dev)
    for ax, ay, phi in shape_grid(lo, hi, dt, dev):
        kd, ks, o = ref_fit.box_ls2(a, ward_aniso(zero, one, ax, ay, phi, cc), y, w,
                                    lo[:2], hi[:2])
        take = o < best
        best = torch.where(take, o, best)
        point = torch.stack([kd, ks, ax.expand_as(kd), ay.expand_as(kd), phi.expand_as(kd)], -1)
        p = torch.where(take[..., None], point, p)
    c_rep = {k: v.repeat_interleave(nc, 0) for k, v in c.items()}
    y_flat = y.reshape(t * nc, -1)
    wk = w
    for r in range(rounds + 1):
        w_flat = wk.reshape(t * nc, -1)

        def residual(q):
            return (ward_aniso(*(q[:, j:j + 1] for j in range(5)), c_rep) - y_flat) * w_flat

        p = ref_fit.lm(residual, p.reshape(t * nc, 5), lo, hi, lm_iters).reshape(t, nc, 5)
        if r < rounds:
            wk = ref_fit.robust_weights(texel_model(c, p) - y, w)
    return p, ((wk * (texel_model(c, p) - y)) ** 2).sum(-1)
