# Copied from brdf_tpu/geometry/visibility.py (host numpy; the port imports nothing of brdf_tpu).
"""Per-(texel, light) visibility from shadow maps: cast-shadow weights.

The reference fits shadowed pixels as if they were lit — its residual model
has no visibility term at all (``brdfdata.cpp:1188-1227``
gathers intensities for every mapped pixel against every LED), so any texel
shadowed by other geometry (the multi-object complexScene especially) pulls
its BRDF parameters toward explaining near-zero measurements it can never
produce. IRLS downweights such views *statistically*; this module removes
them *geometrically*:

1. For each light, place a virtual pinhole camera AT the light position
   looking at the mesh (field of view sized to its bounding sphere) and
   render a depth map with the same host-side z-buffer rasterizer the
   pixel↔surface map uses (``geometry/rasterize.py`` / the C++ core).
2. A texel point is lit by that light iff its depth from the light does not
   exceed the depth-map sample at its projection (plus a discretization
   bias): classic shadow mapping, precomputed host-side.

Like the raster maps, this is a pure-NumPy host precompute that depends only
on fixed scene geometry and stays out of the differentiated path. The
resulting (T, V) visibility multiplies the fit weights
(``build_face_problem`` / ``build_pixel_problem`` ``shadow_weights=True``).
"""

from __future__ import annotations

import numpy as np

from brdf_tpu_torch.geometry.camera import Camera, project_np
from brdf_tpu_torch.geometry.rasterize import rasterize_mesh


def light_camera(
    light_pos: np.ndarray,
    center: np.ndarray,
    radius: float,
    resolution: int = 512,
    margin: float = 1.15,
) -> Camera | None:
    """Pinhole camera at ``light_pos`` looking at ``center`` whose frustum
    covers the sphere (center, radius·margin). Returns None when the light
    sits inside the (margined) bounding sphere — no single pinhole frustum
    covers the whole mesh from there, and the caller falls back to "lit"."""
    light_pos = np.asarray(light_pos, np.float64)
    center = np.asarray(center, np.float64)
    dist = float(np.linalg.norm(center - light_pos))
    r = float(radius) * margin
    if dist <= r * 1.02:
        return None
    # focal length such that the sphere's angular radius maps inside the
    # half-extent of the image plane: tan(asin(r/dist)) · f ≤ res/2
    tan_half = r / np.sqrt(dist * dist - r * r)
    f = 0.5 * resolution / tan_half
    view_dir = (center - light_pos) / dist
    up = np.array([0.0, 1.0, 0.0])
    if abs(float(view_dir @ up)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    return Camera.look_at(
        eye=light_pos, target=center, up=up, f=f,
        width=resolution, height=resolution, dtype=np.float64,
    )


def light_visibility(
    mesh,
    points: np.ndarray,        # (T, 3) texel surface positions
    lights: np.ndarray,        # (V, 3) light positions
    resolution: int = 512,
    bias_pixels: float = 3.0,
    native: bool = True,
) -> np.ndarray:
    """(T, V) float32 visibility: 1.0 = the light sees the point, 0.0 = the
    point is in cast shadow behind other geometry.

    ``bias_pixels`` scales the depth-acne bias in units of the shadow map's
    world-space pixel footprint at the point's distance (slope-independent;
    grazing surfaces that would need more bias also have cos_ln ≈ 0 and
    contribute nothing to the fit either way).
    """
    verts = np.asarray(mesh.vertices, np.float64)
    faces = np.asarray(mesh.faces, np.int64)
    points = np.asarray(points, np.float64)
    lights = np.asarray(lights, np.float64)

    lo, hi = verts.min(axis=0), verts.max(axis=0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - lo)) * 0.5
    if radius == 0.0:
        return np.ones((len(points), len(lights)), np.float32)

    vis = np.ones((len(points), len(lights)), np.float32)
    for vi, light in enumerate(lights):
        cam = light_camera(light, center, radius, resolution=resolution)
        if cam is None:
            continue                      # light inside the scene: keep lit
        depth = rasterize_mesh(cam, verts, faces, native=native).depth
        # 3×3 max-pool: compare against the FARTHEST surface within one
        # shadow-map pixel, which absorbs the slope term of the depth error
        # (a constant bias can't cover grazing surfaces; measured 6.6% acne
        # on an icosphere's oblique ring without this). Costs ≤1 px of
        # shadow-boundary erosion.
        p = np.pad(depth, 1, mode="constant", constant_values=-np.inf)
        h, w = depth.shape
        depth = np.maximum.reduce(
            [p[i : i + h, j : j + w] for i in range(3) for j in range(3)]
        )
        uv, z = project_np(cam, points)
        u = np.clip(np.round(uv[:, 0]).astype(np.int64), 0, resolution - 1)
        v = np.clip(np.round(uv[:, 1]).astype(np.int64), 0, resolution - 1)
        d = depth[v, u].astype(np.float64)
        # world-space footprint of one shadow-map pixel at depth z: z / f
        bias = bias_pixels * np.maximum(z, 0.0) / float(cam.f)
        # lit when: in front of the light (z > 0) and not behind the
        # nearest surface along the light ray (background = inf = lit,
        # e.g. silhouette-edge rounding)
        shadowed = (z > 0) & np.isfinite(d) & (z > d + bias)
        off = (uv[:, 0] < -0.5) | (uv[:, 0] > resolution - 0.5) \
            | (uv[:, 1] < -0.5) | (uv[:, 1] > resolution - 0.5)
        shadowed &= ~off                  # outside the map: conservative lit
        vis[shadowed, vi] = 0.0
    return vis
