# Copied from brdf_tpu/geometry/texel.py (host numpy; the port imports nothing of brdf_tpu).
"""Texel parameterizations: which surface samples get their own BRDF params.

The reference fit per *pixel* of the single reference camera (every covered
pixel got an independent solve using its face's geometry,
``brdfdata.cpp:1195-1221``). This module generalizes that:

- :func:`pixel_texels` — one texel per covered pixel of a chosen reference
  view (optionally strided), with surface position/normal interpolated at the
  actual hit point (barycentric), not the face centroid.
- :func:`sample_views` — per-texel measurements across all views by
  reprojecting the texel's 3D point into each view's camera with bilinear
  image sampling and z-buffer visibility — required for multi-camera rigs
  where pixels don't correspond across views. (With the
  reference's single fixed camera this reduces to reading the same pixel.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from brdf_tpu_torch.geometry.camera import project_np
from brdf_tpu_torch.geometry.mesh import TriangleMesh
from brdf_tpu_torch.geometry.rasterize import RasterMap


class Texelization(NamedTuple):
    points: np.ndarray     # (T, 3) surface positions
    normals: np.ndarray    # (T, 3) unit shading normals
    face_ids: np.ndarray   # (T,)
    pixels: np.ndarray     # (T, 2) [x, y] in the reference view


def pixel_texels(
    mesh: TriangleMesh,
    rm: RasterMap,
    stride: int = 1,
    smooth_normals: bool = True,
) -> Texelization:
    """One texel per covered pixel of the rasterized reference view."""
    cov = rm.coverage
    if stride > 1:
        keep = np.zeros_like(cov)
        keep[::stride, ::stride] = True
        cov = cov & keep
    ys, xs = np.nonzero(cov)
    fids = rm.face_id[ys, xs].astype(np.int64)
    bary = rm.bary[ys, xs].astype(np.float64)

    faces = np.asarray(mesh.faces)[fids]
    tri = np.asarray(mesh.vertices)[faces]                     # (T, 3, 3)
    pts = np.einsum("tk,tkd->td", bary, tri)
    if smooth_normals:
        vn = np.asarray(mesh.vertex_normals)[faces]
        nrm = np.einsum("tk,tkd->td", bary, vn)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    else:
        nrm = np.asarray(mesh.face_normals)[fids]
    return Texelization(
        points=pts,
        normals=nrm,
        face_ids=fids,
        pixels=np.stack([xs, ys], axis=-1),
    )


def _bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample (H, W, C) at float pixel coords; pixel (x, y)'s center
    is at (x+0.5, y+0.5); clamps at borders."""
    h, w = img.shape[:2]
    u = np.clip(u - 0.5, 0.0, w - 1.0)
    v = np.clip(v - 0.5, 0.0, h - 1.0)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fu = (u - x0)[..., None]
    fv = (v - y0)[..., None]
    return (
        img[y0, x0] * (1 - fu) * (1 - fv)
        + img[y0, x1] * fu * (1 - fv)
        + img[y1, x0] * (1 - fu) * fv
        + img[y1, x1] * fu * fv
    )


def sample_views(
    tex: Texelization,
    scene,
    depth_rel_tol: float = 0.01,
    depth_abs_tol: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Measure each texel in every view.

    Returns ``(intensity (T, V, C), weights (T, V))``; weight 0 marks texels
    off-screen, back-facing, or occluded in that view (z-buffer agreement
    within ``max(depth_abs_tol, depth_rel_tol·z)``).
    """
    t = len(tex.points)
    v_count = scene.num_views
    intensity = np.zeros((t, v_count, 3), np.float32)
    weights = np.zeros((t, v_count), np.float32)

    for vi in range(v_count):
        cam = scene.cameras[vi]
        uv, z = project_np(cam, tex.points)
        u, vv = uv[:, 0], uv[:, 1]
        inside = (
            (z > 1e-6)
            & (u >= 0) & (u <= cam.width - 1)
            & (vv >= 0) & (vv <= cam.height - 1)
        )
        # visibility: the view's own z-buffer must agree with the texel depth
        # (floor: pixel (x, y) covers [x, x+1) — centers project to x+0.5)
        rm = scene.raster_map(vi)
        ui = np.clip(np.floor(u).astype(np.int64), 0, cam.width - 1)
        vi_ = np.clip(np.floor(vv).astype(np.int64), 0, cam.height - 1)
        zbuf = rm.depth[vi_, ui]
        tol = np.maximum(depth_abs_tol, depth_rel_tol * np.abs(z))
        visible = inside & np.isfinite(zbuf) & (np.abs(zbuf - z) <= tol)

        intensity[:, vi] = _bilinear(scene.images[vi], u, vv)
        weights[:, vi] = visible.astype(np.float32)

    return intensity, weights
