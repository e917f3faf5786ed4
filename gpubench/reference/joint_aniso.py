"""The anisotropic joint normal map of the ``timber-joint-aniso-16led``
configuration with per-view rig gains, and its reference fit, in plain
torch, in any float dtype (float64 for the check, bfloat16 for the
control). Imports nothing of the program; the scan generator renders with
these.

The lobe is anisotropic GGX (B. Burley, "Physically-Based Shading at
Disney", 2012, appendix B: D with the α = roughness² remap) with the
height-correlated anisotropic Smith masking (E. Heitz, "Understanding the
Masking-Shadowing Function in Microfacet-Based BRDFs", JCGT 2014, eq. 99),
as the program documents it (``models/brdf.py::cook_torrance_aniso``), with
parameters (kd, ks, rough_x, rough_y, phi):

    αx = rough_x², αy = rough_y²
    D   = 1 / (π αx αy ((h_x/αx)² + (h_y/αy)² + (N·H)²)²)
    Vis = 1 / (2 (N·L √((αx v_x)² + (αy v_y)² + (N·V)²)
                  + N·V √((αx l_x)² + (αy l_y)² + (N·L)²)))
    I   = kd/π·⟨N·L⟩ + ks·D·Vis·⟨N·L⟩

where h_x, h_y (l_x, l_y, v_x, v_y) are the half vector's (the light's, the
eye's) components on the material axes. Departures, the program's clamps
and conventions:

- the value is the radiance under a light of unit irradiance, so the BRDF
  is multiplied by ⟨N·L⟩, and F0 is folded into ks (no Fresnel term);
- the specular term lives only where N·L > 0, N·V > 0 and N·H > 0; there
  N·V is floored at 1e-12, as are D's and Vis's denominators, and each
  roughness at 1e-3;
- the material axes are the normal's branchless tangent frame (Duff et al.,
  ``lobes.tangent_frame``) turned by phi about the normal, where the papers
  take a surface parameterisation's.

The joint model (m = 11 a face: RGB kd, RGB ks, rough_x, rough_y, phi, nu,
nv) tilts the face normal N to normalize(N + nu·T + nv·B) in N's frame and
takes the material axes from the tilted normal's own frame
(``lobes.tilted``); the three channels share the shape and the normal.

The reference fit alternates, as the configuration's ``view_gain_rounds``
says, a material fit to the gain-corrected measurements y / g_v with the
closed-form gains g_v = Σ w²·f·y / Σ w²·f² over faces and channels (f the
model's prediction, y and w unscaled), clamped to [0.5, 2] and divided by
their mean; the weights (seen, and the saturation mask taken on the
unscaled measurements) stay as they are. Each round's material fit is a
fit of its own, as the program's is: it starts from a grid, (rough_x,
rough_y, phi) at the untilted normal, then (nu, nv) at the best shape, then
the shape again at the best tilt, each point with every channel's exact
box-constrained (kd, ks) (``fit.box_ls2``); then box-projected
Levenberg–Marquardt on all eleven (``fit.lm``).
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import fit as ref_fit
from gpubench.reference import lobes

EPS = 1e-12
ROUGH_FLOOR = 1e-3
GAIN_CLAMP = (0.5, 2.0)
# the grid: GRID_ROUGH roughnesses a side, geometric over the box's
# roughness from GRID_ROUGH_MIN; GRID_PHIS angles over the quarter turn
# (the lobe is unchanged by (rx, ry, phi) → (ry, rx, phi ± π/2));
# GRID_TILTS offsets a side over the box's tilt
GRID_ROUGH = 7
GRID_ROUGH_MIN = 0.05
GRID_PHIS = 6
GRID_TILTS = 9


def cosines_of(normals, l, v) -> dict:
    """Unit normals (T, 3) and unit directions l, v (T, V, 3) → N·L, N·V,
    N·H and the components of H, L and V on the normal's tangent frame
    (T, B), each (T, V)."""
    n = normals[..., None, :]
    h = lobes._unit(l + v)
    t, b = (x[..., None, :] for x in lobes.tangent_frame(normals))

    def dot(a, c):
        return (a * c).sum(-1)

    return dict(ln=dot(n, l), vn=dot(n, v), nh=dot(n, h), th=dot(t, h), bh=dot(b, h),
                tl=dot(t, l), bl=dot(b, l), tv=dot(t, v), bv=dot(b, v))


def cook_torrance_aniso(kd, ks, rx, ry, phi, c: dict) -> torch.Tensor:
    """The lobe; parameters broadcast against the (..., V) cosines."""
    ax = torch.clamp(rx, min=ROUGH_FLOOR) ** 2
    ay = torch.clamp(ry, min=ROUGH_FLOOR) ** 2
    lit = (c["ln"] > 0) & (c["vn"] > 0) & (c["nh"] > 0)
    one = torch.ones_like(c["ln"])
    zero = torch.zeros_like(c["ln"])
    nl = torch.clamp(c["ln"], min=0.0)
    # outside the lit set every term takes a harmless stand-in, so that
    # neither the value nor its derivatives meet a zero there
    nv = torch.where(lit, torch.clamp(c["vn"], min=EPS), one)
    nh = torch.where(lit, c["nh"], one)
    nl_s = torch.where(lit, nl, one)
    cs, sn = torch.cos(phi), torch.sin(phi)

    def axes(x, y):
        return (torch.where(lit, cs * c[x] + sn * c[y], zero),
                torch.where(lit, -sn * c[x] + cs * c[y], zero))

    hx, hy = axes("th", "bh")
    lx, ly = axes("tl", "bl")
    vx, vy = axes("tv", "bv")
    den = (hx / ax) ** 2 + (hy / ay) ** 2 + nh * nh
    d = 1.0 / torch.clamp(math.pi * ax * ay * den * den, min=EPS)
    lam_v = nl * torch.sqrt((ax * vx) ** 2 + (ay * vy) ** 2 + nv * nv)
    lam_l = nv * torch.sqrt((ax * lx) ** 2 + (ay * ly) ** 2 + nl_s * nl_s)
    vis = 0.5 / torch.clamp(lam_v + lam_l, min=EPS)
    spec = torch.where(lit, ks * d * vis * nl, zero)
    return kd / math.pi * nl + spec


def joint_model(normals, l, v, p) -> torch.Tensor:
    """p (T, 11) [kd_rgb, ks_rgb, rough_x, rough_y, phi, nu, nv] → the
    predictions (T, 3, V) for unit normals (T, 3) and unit l, v (T, V, 3)."""
    c = cosines_of(lobes.tilted(normals, p[:, 9], p[:, 10]), l, v)
    cc = {k: x[:, None, :] for k, x in c.items()}
    shape = (p[:, 6:7, None], p[:, 7:8, None], p[:, 8:9, None])
    return cook_torrance_aniso(p[:, 0:3, None], p[:, 3:6, None], *shape, cc)


def view_gains(pred, y, w) -> torch.Tensor:
    """The closed-form gains of predictions ``pred`` against measurements
    ``y`` under weights ``w``, all (T, 3, V) → (V,): clamped, mean 1."""
    w2 = w * w
    num = (w2 * pred * y).sum((0, 1))
    den = (w2 * pred * pred).sum((0, 1))
    g = torch.where(den > 1e-20, num / torch.where(den > 1e-20, den, torch.ones_like(den)),
                    torch.ones_like(den))
    g = torch.clamp(g, *GAIN_CLAMP)
    return g / g.mean()


def _best(score, best, p, point):
    take = score < best
    return torch.where(take, score, best), torch.where(take[:, None], point, p)


def _shape_grid(normals, l, v, y, w, lo, hi, nu, nv, shapes):
    """At tilt (nu, nv) (T,), the best grid shape with each channel's exact
    (kd, ks): → its summed objective (T,) and parameters (T, 11)."""
    t = len(y)
    c = cosines_of(lobes.tilted(normals, nu, nv), l, v)
    cc = {k: x[:, None, :] for k, x in c.items()}
    one, zero = torch.ones((), dtype=y.dtype, device=y.device), \
        torch.zeros((), dtype=y.dtype, device=y.device)
    a = cook_torrance_aniso(one, zero, one, one, zero, cc)
    best = torch.full((t,), float("inf"), dtype=y.dtype, device=y.device)
    p = torch.zeros((t, 11), dtype=y.dtype, device=y.device)
    for rx, ry, phi in shapes:
        kd, ks, o = ref_fit.box_ls2(a, cook_torrance_aniso(zero, one, rx, ry, phi, cc), y, w,
                                    lo[[0, 3]], hi[[0, 3]])
        rest = torch.stack([rx, ry, phi]).expand(t, 3)
        best, p = _best(o.sum(-1), best, p, torch.cat([kd, ks, rest, nu[:, None],
                                                        nv[:, None]], -1))
    return best, p


def _tilt_grid(normals, l, v, y, w, lo, hi, p, best, tilts):
    """At each face's shape of ``p``, the best grid tilt with each channel's
    exact (kd, ks)."""
    t = len(y)
    for nu in tilts:
        for nv in tilts:
            c = cosines_of(lobes.tilted(normals, nu.expand(t), nv.expand(t)), l, v)
            cc = {k: x[:, None, :] for k, x in c.items()}
            one = torch.ones((t, 1, 1), dtype=y.dtype, device=y.device)
            zero = torch.zeros_like(one)
            shape = (p[:, 6:7, None], p[:, 7:8, None], p[:, 8:9, None])
            a = cook_torrance_aniso(one, zero, *shape, cc)
            b = cook_torrance_aniso(zero, one, *shape, cc)
            kd, ks, o = ref_fit.box_ls2(a, b, y, w, lo[[0, 3]], hi[[0, 3]])
            point = torch.cat([kd, ks, p[:, 6:9], nu.expand(t, 1), nv.expand(t, 1)], -1)
            best, p = _best(o.sum(-1), best, p, point)
    return best, p


def grid_start(normals, l, v, y, w, lo, hi) -> torch.Tensor:
    """The grid's start (T, 11) for y, w (T, 3, V)."""
    dt, dev = y.dtype, y.device
    r_lo = max(float(lo[6]), float(lo[7]), GRID_ROUGH_MIN)
    r_hi = min(float(hi[6]), float(hi[7]))
    rough = torch.logspace(math.log10(r_lo), math.log10(r_hi), GRID_ROUGH, dtype=torch.float64)
    phis = torch.arange(GRID_PHIS, dtype=torch.float64) * (0.5 * math.pi / GRID_PHIS)
    phis = phis[(phis >= float(lo[8])) & (phis <= float(hi[8]))]
    shapes = torch.cartesian_prod(rough, rough, phis).to(dev, dt)
    tilts = torch.linspace(float(lo[9]), float(hi[9]), GRID_TILTS, dtype=dt, device=dev)
    zero = torch.zeros(len(y), dtype=dt, device=dev)
    best, p = _shape_grid(normals, l, v, y, w, lo, hi, zero, zero, shapes)
    best, p = _tilt_grid(normals, l, v, y, w, lo, hi, p, best, tilts)
    again, q = _shape_grid(normals, l, v, y, w, lo, hi, p[:, 9], p[:, 10], shapes)
    return torch.where((again < best)[:, None], q, p)


def fit_joint_gains(normals, l, v, y, w, lower, upper, gain_rounds: int, lm_iters: int = 60,
                    p0=None):
    """The joint normal map with per-view gains: y, w (T, 3, V) unscaled →
    p (T, 11), the gains (V,) and the χ² (T,) of the gain-corrected
    measurements at the last round. ``p0`` (T, 11), if given, starts every
    round's LM in the grid's place."""
    dt, dev = y.dtype, y.device
    lo = torch.tensor(lower, dtype=dt, device=dev)
    hi = torch.tensor(upper, dtype=dt, device=dev)
    t = len(y)
    gains = torch.ones(y.shape[-1], dtype=dt, device=dev)
    for r in range(gain_rounds + 1):
        ys = y / gains

        def residual(q):
            return ((joint_model(normals, l, v, q) - ys) * w).reshape(t, -1)

        start = grid_start(normals, l, v, ys, w, lo, hi) if p0 is None else p0
        p = ref_fit.lm(residual, start, lo, hi, lm_iters)
        if r < gain_rounds:
            gains = view_gains(joint_model(normals, l, v, p), y, w)
    return p, gains, residual(p).pow(2).sum(-1)
