# Adapted from brdf_tpu/pipeline/envlight.py (the port imports nothing of brdf_tpu).
"""Image-based (environment-map) relighting.

The reference could only re-shade under its 16-LED rig or a headlight at the
eye (``glutcallbacks.cpp:346-445``); this module relights fitted BRDF maps
under arbitrary lat-long HDR environments.

Two integration paths:

- **Sampled specular/general**: the environment is converted host-side (pure
  NumPy, copied from the JAX package) into N directional lights with RGB
  radiance weights — luminance-importance sampled (deterministic systematic
  resampling) or uniform Fibonacci-sphere quadrature — and shaded through the
  registered lobes on the device: :func:`shade_env_samples` puts the S
  samples in the view slot of the shading kernel K2 (``ops/shading.py::
  shade``, as ``pipeline/render.py::render_pixels`` does) and weights the
  lobe by the radiance. Any registry model works, the anisotropic ones
  included.
- **SH9 diffuse irradiance**: the Ramamoorthi-Hanrahan 9-coefficient
  irradiance map, exact for a Lambertian response up to SH band 2, evaluated
  in closed form per normal.

Lat-long convention: rows are the polar angle θ ∈ [0, π] measured from +Y
(y-up), columns the azimuth φ ∈ [0, 2π) with direction
``(sinθ·cosφ, cosθ, sinθ·sinφ)``; a pixel subtends Δω = (2π/W)(π/H)·sinθ.
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.models.brdf import (
    MODELS,
    ShadingAngles,
    ShadingGeometry,
    _normalize,
    angles_from_geometry,
)
from brdf_tpu_torch.ops.shading import shade


def latlong_directions(height: int, width: int) -> np.ndarray:
    """(H, W, 3) unit direction of each lat-long pixel center (y-up)."""
    theta = (np.arange(height) + 0.5) * np.pi / height
    phi = (np.arange(width) + 0.5) * 2.0 * np.pi / width
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    return np.stack(
        [st * np.cos(phi)[None, :], np.broadcast_to(ct, (height, width)),
         st * np.sin(phi)[None, :]],
        axis=-1,
    )


def latlong_solid_angles(height: int, width: int) -> np.ndarray:
    """(H, W) solid angle of each pixel; sums to exactly 4π.

    Uses the exact per-row integral ∫sinθ dθ = cosθ₀ − cosθ₁ over each
    pixel's polar band (not the midpoint value), so total energy is
    conserved at any resolution."""
    edges = np.arange(height + 1) * np.pi / height
    band = np.cos(edges[:-1]) - np.cos(edges[1:])        # (H,), sums to 2
    return np.broadcast_to(
        (band * (2.0 * np.pi / width))[:, None], (height, width)
    ).copy()


def _luminance(rgb: np.ndarray) -> np.ndarray:
    return rgb @ np.asarray([0.2126, 0.7152, 0.0722], rgb.dtype)


def env_to_lights(
    env: np.ndarray,            # (H, W, C) linear radiance, lat-long
    n: int = 256,
    method: str = "importance",  # "importance" | "uniform"
) -> tuple[np.ndarray, np.ndarray]:
    """Convert an environment map into ``n`` directional lights.

    Returns ``(dirs (n, 3), radiance (n, C))`` such that
    ``Σ_s radiance_s · brdf(ω_s)·cosθ_s`` estimates the true environment
    integral ``∫ L(ω)·brdf(ω)·cosθ dω``. Host-side pure NumPy.

    ``importance`` draws pixels ∝ luminance·Δω with *systematic* resampling
    (deterministic: no RNG, stratified offsets), weighting each sample by
    ``W_tot/(n·lum_s)·L_s`` — low variance for peaked HDR skies.
    ``uniform`` places a Fibonacci sphere and weights by ``L(ω_s)·4π/n``
    (bilinear lookup) — robust for smooth environments and exact-quadrature
    tests.
    """
    env = np.asarray(env, np.float64)
    if env.ndim == 2:
        env = env[..., None]
    h, w, c = env.shape
    if method == "importance":
        dirs_all = latlong_directions(h, w).reshape(-1, 3)
        dw = latlong_solid_angles(h, w).reshape(-1)
        lum = np.maximum(_luminance(env.reshape(-1, c)), 0.0)
        wgt = lum * dw
        total = wgt.sum()
        if total <= 0:
            raise ValueError("environment map has no positive luminance")
        # systematic (stratified) resampling: deterministic, O(HW)
        cdf = np.cumsum(wgt) / total
        u = (np.arange(n) + 0.5) / n
        idx = np.searchsorted(cdf, u)
        rad = (total / n) * env.reshape(-1, c)[idx] / lum[idx, None]
        return dirs_all[idx].astype(np.float32), rad.astype(np.float32)
    if method == "uniform":
        # Fibonacci sphere: near-uniform deterministic quadrature
        i = np.arange(n) + 0.5
        y = 1.0 - 2.0 * i / n
        r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
        ga = np.pi * (3.0 - np.sqrt(5.0))
        dirs = np.stack([r * np.cos(ga * i), y, r * np.sin(ga * i)], axis=-1)
        rad = lookup_latlong(env, dirs) * (4.0 * np.pi / n)
        return dirs.astype(np.float32), rad.astype(np.float32)
    raise ValueError(f"unknown sampling method {method!r} (importance | uniform)")


def lookup_latlong(env: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Bilinear lat-long lookup of unit ``dirs`` (..., 3) → (..., C).
    Azimuth wraps; polar clamps (host-side NumPy)."""
    env = np.asarray(env, np.float64)
    h, w, c = env.shape
    d = np.asarray(dirs, np.float64)
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0))
    phi = np.arctan2(d[..., 2], d[..., 0]) % (2.0 * np.pi)
    fy = theta * h / np.pi - 0.5
    fx = phi * w / (2.0 * np.pi) - 0.5
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    ty = (fy - y0)[..., None]
    tx = (fx - x0)[..., None]
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    x0w = x0 % w
    x1w = (x0 + 1) % w
    v00 = env[y0c, x0w]
    v01 = env[y0c, x1w]
    v10 = env[y1c, x0w]
    v11 = env[y1c, x1w]
    return (1 - ty) * ((1 - tx) * v00 + tx * v01) + ty * ((1 - tx) * v10 + tx * v11)


# ---------------------------------------------------------------------------
# SH9 irradiance (Ramamoorthi & Hanrahan 2001)
# ---------------------------------------------------------------------------

_SH_C = np.asarray(
    [0.282095,                      # Y00
     0.488603, 0.488603, 0.488603,  # Y1-1 (y), Y10 (z), Y11 (x)
     1.092548, 1.092548,            # Y2-2 (xy), Y2-1 (yz)
     0.315392,                      # Y20 (3z²−1)
     1.092548, 0.546274]            # Y21 (xz), Y22 (x²−y²)
)
# clamped-cosine convolution coefficients Â_l = (π, 2π/3, π/4)
_SH_A = np.asarray(
    [np.pi,
     2 * np.pi / 3, 2 * np.pi / 3, 2 * np.pi / 3,
     np.pi / 4, np.pi / 4, np.pi / 4, np.pi / 4, np.pi / 4]
)


def _sh9_basis(d):
    """Evaluate the 9 real SH basis functions at unit dirs (..., 3) → (..., 9),
    for NumPy arrays and tensors alike."""
    tensor = isinstance(d, torch.Tensor)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c = torch.as_tensor(_SH_C, dtype=d.dtype, device=d.device) if tensor else _SH_C
    stack = torch.stack if tensor else np.stack
    ones = torch.ones_like(x) if tensor else np.ones_like(x)
    return stack(
        [
            c[0] * ones,
            c[1] * y, c[2] * z, c[3] * x,
            c[4] * x * y, c[5] * y * z,
            c[6] * (3 * z * z - 1.0),
            c[7] * x * z, c[8] * (x * x - y * y),
        ],
        -1,
    )


def sh9_project(env: np.ndarray) -> np.ndarray:
    """Project a lat-long environment onto the first 9 SH coefficients:
    ``L_lm = Σ_pixels L(ω)·Y_lm(ω)·Δω``. Returns (9, C). Host-side."""
    env = np.asarray(env, np.float64)
    if env.ndim == 2:
        env = env[..., None]
    h, w, c = env.shape
    dirs = latlong_directions(h, w).reshape(-1, 3)
    dw = latlong_solid_angles(h, w).reshape(-1)
    basis = _sh9_basis(dirs)                           # (HW, 9)
    return np.einsum("pk,p,pc->kc", basis, dw, env.reshape(-1, c))


def sh9_irradiance(normals, coeffs) -> torch.Tensor:
    """Diffuse irradiance ``E(n) = Σ Â_l L_lm Y_lm(n)`` per normal:
    (..., 3) × (9, C) → (..., C), on the normals' device and in their dtype."""
    basis = _sh9_basis(torch.as_tensor(normals))           # (..., 9)
    a = torch.as_tensor(_SH_A, dtype=basis.dtype, device=basis.device)
    return torch.einsum("...k,kc->...c", basis * a,
                        torch.as_tensor(coeffs).to(basis))


# ---------------------------------------------------------------------------
# Shading under directional environment samples
# ---------------------------------------------------------------------------


def directional_angles(normals, points, eye, dirs, tangent_frame: bool = False) -> ShadingAngles:
    """Shading angles for *directional* lights: L is the (constant) sample
    direction instead of a normalized texel→LED vector. Tensors in,
    ``(N, S)`` channels out."""
    l = dirs[None, :, :].expand((normals.shape[0],) + tuple(dirs.shape))
    if eye.ndim == 1:
        v = _normalize(eye - points)[..., None, :]
    else:
        v = _normalize(eye - points[..., None, :])
    geom = ShadingGeometry(n=normals, l=l, v=v.expand(l.shape))
    return angles_from_geometry(geom, tangent_frame=tangent_frame)


def shade_env_samples(
    model: str,
    params,                 # (N, C, m) per-texel per-channel parameters
    points,                 # (N, 3)
    normals,                # (N, 3)
    eye,                    # (3,)
    dirs,                   # (S, 3) environment sample directions
    radiance,               # (S, C) per-sample RGB radiance·Δω weights
    device=None,
) -> torch.Tensor:
    """Shade N surface samples under S directional environment samples;
    returns (N, C) on ``device`` (``cuda`` unless the caller passes
    another). Inputs are tensors or NumPy arrays and keep their dtype.

    The lobe goes through the shading kernel K2 (``ops/shading.py::shade``;
    on the CPU its plain version) with the S samples in the view slot and
    every sample's angles repeated for the C channels. The radiance then
    weights the samples and they are summed."""
    dev = resolve_device(device)
    params, points, normals, eye, dirs, radiance = (
        torch.as_tensor(x).to(dev) for x in (params, points, normals, eye, dirs, radiance))
    spec = MODELS[model]
    ang = directional_angles(normals, points, eye, dirs, tangent_frame=spec.tangent)
    n, c, m = params.shape
    ang_flat = ShadingAngles(*(
        None if a is None else a.repeat_interleave(c, dim=0) for a in ang))
    vals = shade(model, params.reshape(n * c, m), ang_flat).reshape(n, c, -1)
    return torch.einsum("ncs,sc->nc", vals, radiance.to(vals.dtype))


def relight_env(
    model: str,
    scene,
    params: np.ndarray,
    face_ids: np.ndarray,
    env: np.ndarray,
    view: int = 0,
    n_samples: int = 256,
    method: str = "importance",
    background: float = 0.0,
    use_vertex_normals: bool = True,
    device=None,
) -> np.ndarray:
    """Render one camera view of the fitted scene under an environment map —
    the IBL counterpart of :func:`brdf_tpu_torch.pipeline.render.relight`.
    The covered pixels are gathered on the host and shaded on ``device``
    (``cuda`` unless the caller passes another) by :func:`shade_env_samples`."""
    from brdf_tpu_torch.pipeline.render import gather_covered_pixels

    dirs, rad = env_to_lights(env, n=n_samples, method=method)
    rm = scene.raster_map(view)
    cam = scene.cameras[view]

    cov, pts, nrm, p_px, valid = gather_covered_pixels(
        scene.mesh, rm, params, face_ids, use_vertex_normals=use_vertex_normals
    )

    c = params.shape[1]
    if rad.shape[1] == 1 and c > 1:
        rad = np.repeat(rad, c, axis=1)
    with torch.no_grad():
        shaded = shade_env_samples(
            model,
            np.asarray(p_px),
            np.asarray(pts, np.float32),
            np.asarray(nrm, np.float32),
            np.asarray(cam.position),
            np.asarray(dirs, np.float32),
            np.asarray(rad[:, :c], np.float32),
            device=device,
        )
    img = np.full((cam.height, cam.width, c), background, np.float32)
    img[cov] = shaded.cpu().numpy() * valid[:, None]
    return img
