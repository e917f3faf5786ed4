"""Differentiable BRDF shading models in PyTorch.

Port of ``brdf_tpu/models/brdf.py``: the same angle channels, the same ten
lobes with the same clamp and mask conventions (so ``torch.autograd`` gives
the gradients ``jax.grad`` gives), and the same ``MODELS`` registry. The
host-side numpy builders (``shading_geometry_np``, ``angles_from_geometry_np``)
are copied from that module.

Every lobe is ``f(params (..., M), angles (..., V) channels) → (..., V)`` and
broadcasts. ``jnp.maximum``/``jnp.clip`` split the gradient at a tie; so does
``torch.maximum``/``torch.minimum`` with a tensor bound, which is why the
clamps below use them and not ``torch.clamp`` (whose tie gradient is 1).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

_EPS = 1e-12


class ShadingGeometry(NamedTuple):
    """Unit vectors per (texel, light): ``n`` (..., 3), ``l``/``v`` (..., V, 3)."""

    n: torch.Tensor
    l: torch.Tensor
    v: torch.Tensor


class ShadingAngles(NamedTuple):
    """Cosine terms per (texel, light); all (..., V). The six tangent-frame
    channels are ``None`` unless the angles were built with
    ``tangent_frame=True`` (the anisotropic lobes read them); the frame is
    :func:`brdf_tpu_torch.models.normalmap.tangent_basis`'s."""

    cos_ln: torch.Tensor  # N·L
    cos_nh: torch.Tensor  # N·H
    cos_rv: torch.Tensor  # R·V
    cos_vn: torch.Tensor  # N·V
    cos_th: torch.Tensor | None = None  # T·H
    cos_bh: torch.Tensor | None = None  # B·H
    cos_tl: torch.Tensor | None = None  # T·L
    cos_bl: torch.Tensor | None = None  # B·L
    cos_tv: torch.Tensor | None = None  # T·V
    cos_bv: torch.Tensor | None = None  # B·V


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(c))


def _min(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(c))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient convention (half at either bound)."""
    return _min(_max(x, lo), hi)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / _max(torch.linalg.vector_norm(x, dim=-1, keepdim=True), _EPS)


def shading_geometry(points, normals, eye, lights) -> ShadingGeometry:
    """points (..., 3), normals (..., 3), eye (3,) or (V, 3), lights (V, 3)."""
    l = _normalize(lights - points[..., None, :])
    if eye.ndim == 1:
        v = _normalize(eye - points)[..., None, :]
    else:
        v = _normalize(eye - points[..., None, :])
    return ShadingGeometry(n=normals, l=l, v=v.expand(l.shape))


def angles_from_geometry(geom: ShadingGeometry, tangent_frame: bool = False) -> ShadingAngles:
    n = geom.n[..., None, :]
    cos_ln = torch.sum(n * geom.l, dim=-1)
    h = _normalize(geom.l + geom.v)
    cos_nh = torch.sum(n * h, dim=-1)
    r = 2.0 * cos_ln[..., None] * n - geom.l
    cos_rv = torch.sum(r * geom.v, dim=-1)
    cos_vn = torch.sum(n * geom.v, dim=-1)
    ext = {}
    if tangent_frame:
        from brdf_tpu_torch.models.normalmap import tangent_basis

        t, b = tangent_basis(geom.n)
        t = t[..., None, :]
        b = b[..., None, :]
        ext = dict(
            cos_th=torch.sum(t * h, dim=-1), cos_bh=torch.sum(b * h, dim=-1),
            cos_tl=torch.sum(t * geom.l, dim=-1), cos_bl=torch.sum(b * geom.l, dim=-1),
            cos_tv=torch.sum(t * geom.v, dim=-1), cos_bv=torch.sum(b * geom.v, dim=-1),
        )
    return ShadingAngles(cos_ln=cos_ln, cos_nh=cos_nh, cos_rv=cos_rv, cos_vn=cos_vn, **ext)


def shading_angles(points, normals, eye, lights, tangent_frame: bool = False) -> ShadingAngles:
    """Cosine terms for every (texel, light) pair (torch tensors)."""
    return angles_from_geometry(
        shading_geometry(points, normals, eye, lights), tangent_frame=tangent_frame
    )


# copied from brdf_tpu/models/brdf.py (host numpy, float64 accumulation)
def shading_geometry_np(points, normals, eye, lights) -> ShadingGeometry:
    """Numpy twin of :func:`shading_geometry` for host-side problem building."""
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    eye = np.asarray(eye, np.float64)
    lights = np.asarray(lights, np.float64)

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), _EPS)

    l = norm(lights - points[..., None, :])
    if eye.ndim == 1:
        v = norm(eye - points)[..., None, :]
    else:
        v = norm(eye - points[..., None, :])
    v = np.broadcast_to(v, l.shape)
    return ShadingGeometry(n=normals, l=l, v=v)


def angles_from_geometry_np(
    geom: ShadingGeometry, tangent_frame: bool = False, dtype=np.float32
) -> ShadingAngles:
    """Numpy twin of :func:`angles_from_geometry`; returns numpy channels."""
    n = np.asarray(geom.n, np.float64)[..., None, :]
    l = np.asarray(geom.l, np.float64)
    v = np.asarray(geom.v, np.float64)
    cos_ln = np.sum(n * l, axis=-1)
    h = l + v
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), _EPS)
    cos_nh = np.sum(n * h, axis=-1)
    r = 2.0 * cos_ln[..., None] * n - l
    cos_rv = np.sum(r * v, axis=-1)
    cos_vn = np.sum(n * v, axis=-1)
    ext = {}
    if tangent_frame:
        from brdf_tpu_torch.models.normalmap import tangent_basis_np

        t, b = tangent_basis_np(np.asarray(geom.n, np.float64))
        t = t[..., None, :]
        b = b[..., None, :]
        ext = dict(
            cos_th=np.sum(t * h, -1).astype(dtype),
            cos_bh=np.sum(b * h, -1).astype(dtype),
            cos_tl=np.sum(t * l, -1).astype(dtype),
            cos_bl=np.sum(b * l, -1).astype(dtype),
            cos_tv=np.sum(t * v, -1).astype(dtype),
            cos_bv=np.sum(b * v, -1).astype(dtype),
        )
    return ShadingAngles(
        cos_ln=cos_ln.astype(dtype), cos_nh=cos_nh.astype(dtype),
        cos_rv=cos_rv.astype(dtype), cos_vn=cos_vn.astype(dtype), **ext,
    )


# ---------------------------------------------------------------------------
# Lobes
# ---------------------------------------------------------------------------


def _safe_pow(base: torch.Tensor, expo) -> torch.Tensor:
    """``max(base, 0)^expo`` with finite gradients at base<=0."""
    clamped = _max(base, _EPS)
    return torch.where(base > 0, torch.pow(clamped, expo), torch.zeros_like(clamped))


def phong(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """``I = kd·⟨N·L⟩ + ks·(n+2)/(2π)·⟨R·V⟩ⁿ``, specular horizon-masked."""
    kd, ks, n = params[..., 0:1], params[..., 1:2], params[..., 2:3]
    diff = kd * _max(angles.cos_ln, 0.0)
    spec = ks * (n + 2.0) / (2.0 * math.pi) * _safe_pow(angles.cos_rv, n)
    return diff + spec * (angles.cos_ln > 0)


def blinn_phong(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """``I = kd·⟨N·L⟩ + ks·⟨N·H⟩ⁿ``, specular horizon-masked."""
    kd, ks, n = params[..., 0:1], params[..., 1:2], params[..., 2:3]
    diff = kd * _max(angles.cos_ln, 0.0)
    spec = ks * _safe_pow(angles.cos_nh, n)
    return diff + spec * (angles.cos_ln > 0)


def cook_torrance(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """GGX distribution, height-correlated Smith visibility, F0 folded into
    ks: ``I = kd/π·⟨N·L⟩ + ks·D·V·⟨N·L⟩``; params ``(kd, ks, roughness)``."""
    kd, ks = params[..., 0:1], params[..., 1:2]
    rough = _max(params[..., 2:3], 1e-3)
    a2 = (rough * rough) ** 2
    nl = _max(angles.cos_ln, 0.0)
    nv = _max(angles.cos_vn, _EPS)
    nh = _max(angles.cos_nh, 0.0)
    d_denom = nh * nh * (a2 - 1.0) + 1.0
    d = a2 / _max(math.pi * d_denom * d_denom, _EPS)
    lam_v = nl * torch.sqrt(nv * nv * (1.0 - a2) + a2)
    lam_l = nv * torch.sqrt(nl * nl * (1.0 - a2) + a2)
    vis = 0.5 / _max(lam_v + lam_l, _EPS)
    spec = ks * d * vis * nl
    diff = kd / math.pi * nl
    return diff + spec * (nl > 0)


def _lv_from_angles(angles: ShadingAngles) -> torch.Tensor:
    """L·V = 2(N·L)(N·V) − R·V."""
    return 2.0 * angles.cos_ln * angles.cos_vn - angles.cos_rv


def cook_torrance_fresnel(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Cook-Torrance ``(kd, ks, roughness, f0)`` with a live Schlick term."""
    base = cook_torrance(params[..., :3], angles)
    kd, f0 = params[..., 0:1], params[..., 3:4]
    nl = _max(angles.cos_ln, 0.0)
    lv = _lv_from_angles(angles)
    vh = torch.sqrt(_max((1.0 + lv) / 2.0, _EPS))
    fresnel = f0 + (1.0 - f0) * _safe_pow(1.0 - vh, 5.0)
    diff = kd / math.pi * nl
    spec = base - diff
    return diff + spec * fresnel


def lambert(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """``I = kd/π·⟨N·L⟩``."""
    return params[..., 0:1] / math.pi * _max(angles.cos_ln, 0.0)


def oren_nayar(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Oren-Nayar rough diffuse (qualitative model), params ``(kd, sigma)``."""
    kd, sigma = params[..., 0:1], params[..., 1:2]
    s2 = sigma * sigma
    a_coef = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b_coef = 0.45 * s2 / (s2 + 0.09)
    nl = _clip(angles.cos_ln, -1.0, 1.0)
    nv = _clip(angles.cos_vn, -1.0, 1.0)
    sin_i = torch.sqrt(_max(1.0 - nl * nl, 0.0))
    sin_r = torch.sqrt(_max(1.0 - nv * nv, 0.0))
    lv = _lv_from_angles(angles)
    cos_phi = _clip((lv - nl * nv) / _max(sin_i * sin_r, _EPS), -1.0, 1.0)
    cos_alpha = torch.minimum(nl, nv)
    cos_beta = torch.maximum(nl, nv)
    sin_alpha = torch.sqrt(_max(1.0 - cos_alpha * cos_alpha, 0.0))
    tan_beta = torch.sqrt(_max(1.0 - cos_beta * cos_beta, 0.0)) / _max(cos_beta, _EPS)
    term = a_coef + b_coef * _max(cos_phi, 0.0) * sin_alpha * tan_beta
    return kd / math.pi * _max(nl, 0.0) * term


def ward(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Isotropic Ward (Walter's normalization), params ``(kd, ks, alpha)``.
    Masked by double-where so no NaN or overflow leaks through dead lanes."""
    kd, ks = params[..., 0:1], params[..., 1:2]
    alpha = _max(params[..., 2:3], 1e-3)
    a2 = alpha * alpha
    nl = _max(angles.cos_ln, 0.0)
    nv = _max(angles.cos_vn, _EPS)
    lit = (angles.cos_ln > 0) & (angles.cos_nh > 0) & (angles.cos_vn > 0)
    one = torch.ones_like(angles.cos_nh)
    nh = _max(torch.where(lit, angles.cos_nh, one), 1e-4)
    tan2 = (1.0 - nh * nh) / (nh * nh)
    lobe = torch.exp(-tan2 / a2) / (4.0 * math.pi * a2)
    rt = torch.sqrt(torch.where(lit, nl, one) / nv)
    spec = ks * torch.where(lit, rt * lobe, torch.zeros_like(lobe))
    return kd / math.pi * nl + spec


def minnaert(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """``I = kd·⟨N·L⟩ᵏ·⟨N·V⟩^(k−1)``, params ``(kd, k)``."""
    kd, k = params[..., 0:1], params[..., 1:2]
    nl = _max(angles.cos_ln, 0.0)
    nv = _max(angles.cos_vn, _EPS)
    lit = (angles.cos_ln > 0) & (angles.cos_vn > 0)
    return kd * _safe_pow(nl, k) * _safe_pow(nv, k - 1.0) * lit


def _rotated_tangent_components(phi, ct, cb):
    c, s = torch.cos(phi), torch.sin(phi)
    return c * ct + s * cb, -s * ct + c * cb


def _require_tangent(angles: ShadingAngles, model: str) -> None:
    if angles.cos_th is None:
        raise ValueError(
            f"model {model!r} needs tangent-frame angle channels (cos_th … cos_bv)"
        )


def ward_aniso(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Anisotropic Ward, params ``(kd, ks, alpha_x, alpha_y, phi)``."""
    _require_tangent(angles, "ward_aniso")
    kd, ks = params[..., 0:1], params[..., 1:2]
    ax = _max(params[..., 2:3], 1e-3)
    ay = _max(params[..., 3:4], 1e-3)
    phi = params[..., 4:5]
    nl = _max(angles.cos_ln, 0.0)
    nv = _max(angles.cos_vn, _EPS)
    lit = (angles.cos_ln > 0) & (angles.cos_nh > 0) & (angles.cos_vn > 0)
    one = torch.ones_like(angles.cos_nh)
    nh = _max(torch.where(lit, angles.cos_nh, one), 1e-4)
    ht, hb = _rotated_tangent_components(phi, angles.cos_th, angles.cos_bh)
    ht = torch.where(lit, ht, torch.zeros_like(ht))
    hb = torch.where(lit, hb, torch.zeros_like(hb))
    expo = ((ht / ax) ** 2 + (hb / ay) ** 2) / (nh * nh)
    lobe = torch.exp(-expo) / (4.0 * math.pi * ax * ay)
    rt = torch.sqrt(torch.where(lit, nl, one) / nv)
    spec = ks * torch.where(lit, rt * lobe, torch.zeros_like(lobe))
    return kd / math.pi * nl + spec


def cook_torrance_aniso(params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Anisotropic GGX + height-correlated anisotropic Smith, Disney
    ``α = r²`` remap; params ``(kd, ks, rough_x, rough_y, phi)``."""
    _require_tangent(angles, "cook_torrance_aniso")
    kd, ks = params[..., 0:1], params[..., 1:2]
    ax = _max(params[..., 2:3], 1e-3) ** 2
    ay = _max(params[..., 3:4], 1e-3) ** 2
    phi = params[..., 4:5]
    lit = (angles.cos_ln > 0) & (angles.cos_vn > 0) & (angles.cos_nh > 0)
    one = torch.ones_like(angles.cos_ln)
    nl = _max(angles.cos_ln, 0.0)
    nv = torch.where(lit, _max(angles.cos_vn, _EPS), one)
    nh = torch.where(lit, angles.cos_nh, one)

    def live(x):
        return torch.where(lit, x, torch.zeros_like(x))

    ht, hb = map(live, _rotated_tangent_components(phi, angles.cos_th, angles.cos_bh))
    lt, lb = map(live, _rotated_tangent_components(phi, angles.cos_tl, angles.cos_bl))
    vt, vb = map(live, _rotated_tangent_components(phi, angles.cos_tv, angles.cos_bv))
    d_denom = (ht / ax) ** 2 + (hb / ay) ** 2 + nh * nh
    d = 1.0 / _max(math.pi * ax * ay * d_denom * d_denom, _EPS)
    nl_s = torch.where(lit, nl, one)
    lam_v = nl * torch.sqrt((ax * vt) ** 2 + (ay * vb) ** 2 + nv * nv)
    lam_l = nv * torch.sqrt((ax * lt) ** 2 + (ay * lb) ** 2 + nl_s * nl_s)
    vis = 0.5 / _max(lam_v + lam_l, _EPS)
    spec = ks * d * vis * nl
    diff = kd / math.pi * nl
    return diff + live(spec)


class ModelSpec(NamedTuple):
    name: str
    n_params: int
    fn: Callable[[torch.Tensor, ShadingAngles], torch.Tensor]
    param_names: tuple[str, ...]
    p0: tuple[float, ...]
    lower: tuple[float, ...]
    upper: tuple[float, ...]
    linear: int = 2             # leading params the lobe is linear in
    tangent: bool = False       # needs tangent-frame angle channels


MODELS: dict[str, ModelSpec] = {
    "phong": ModelSpec(
        "phong", 3, phong, ("kd", "ks", "n"),
        (0.5, 1.0, 1.0), (0.0, 0.0, 0.0), (100.0, 100.0, 100.0),
    ),
    "blinn_phong": ModelSpec(
        "blinn_phong", 3, blinn_phong, ("kd", "ks", "n"),
        (0.5, 1.0, 1.0), (0.0, 0.0, 0.0), (100.0, 100.0, 100.0),
    ),
    "cook_torrance": ModelSpec(
        "cook_torrance", 3, cook_torrance, ("kd", "ks", "roughness"),
        (0.5, 0.5, 0.5), (0.0, 0.0, 1e-3), (100.0, 100.0, 1.0),
    ),
    "cook_torrance_fresnel": ModelSpec(
        "cook_torrance_fresnel", 4, cook_torrance_fresnel,
        ("kd", "ks", "roughness", "f0"),
        (0.5, 0.5, 0.5, 0.5), (0.0, 0.0, 1e-3, 0.0), (100.0, 100.0, 1.0, 1.0),
    ),
    "lambert": ModelSpec(
        "lambert", 1, lambert, ("kd",), (0.5,), (0.0,), (100.0,), linear=1,
    ),
    "oren_nayar": ModelSpec(
        "oren_nayar", 2, oren_nayar, ("kd", "sigma"),
        (0.5, 0.3), (0.0, 0.0), (100.0, 1.5), linear=1,
    ),
    "ward": ModelSpec(
        "ward", 3, ward, ("kd", "ks", "alpha"),
        (0.5, 0.5, 0.3), (0.0, 0.0, 1e-3), (100.0, 100.0, 1.0),
    ),
    "minnaert": ModelSpec(
        "minnaert", 2, minnaert, ("kd", "k"),
        (0.5, 1.0), (0.0, 0.3), (100.0, 3.0), linear=1,
    ),
    "ward_aniso": ModelSpec(
        "ward_aniso", 5, ward_aniso, ("kd", "ks", "alpha_x", "alpha_y", "phi"),
        (0.5, 0.5, 0.3, 0.3, 0.0),
        (0.0, 0.0, 1e-3, 1e-3, -math.pi / 2),
        (100.0, 100.0, 1.0, 1.0, math.pi / 2),
        tangent=True,
    ),
    "cook_torrance_aniso": ModelSpec(
        "cook_torrance_aniso", 5, cook_torrance_aniso,
        ("kd", "ks", "rough_x", "rough_y", "phi"),
        (0.5, 0.5, 0.5, 0.5, 0.0),
        (0.0, 0.0, 1e-3, 1e-3, -math.pi / 2),
        (100.0, 100.0, 1.0, 1.0, math.pi / 2),
        tangent=True,
    ),
}


def brdf_eval(model: str, params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Evaluate a registered model by name."""
    return MODELS[model].fn(params, angles)
