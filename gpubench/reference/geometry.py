"""Plain NumPy geometry of a scan: normals, the Tsai projection, the
z-buffered raster map, pixel texels, per-view sampling and the face problem.

Written from the semantics the program documents (pixel centres at
``(x + 0.5, y + 0.5)``, edge-function barycentrics, perspective-correct
depth through 1/z, the nearest hit kept, first face on a tie; area-weighted
vertex normals; bilinear view sampling with a z-buffer visibility test), in
float64, with the arithmetic in the order of the rasterizer's C++ core so
that both give the same map. Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

EPS = 1e-12


class Camera(NamedTuple):
    """A Tsai camera as a scan states it (float32 values, as read from a
    ``.cal``); ``rotation`` rows are the camera axes in world coordinates."""

    rotation: np.ndarray
    position: np.ndarray
    f: float
    cx: float
    cy: float
    sx: float
    kappa1: float
    width: int
    height: int


class RasterMap(NamedTuple):
    face_id: np.ndarray   # (H, W) int32, -1 where no face is seen
    bary: np.ndarray      # (H, W, 3) float32
    depth: np.ndarray     # (H, W) float32, inf where no face is seen


def look_at(eye, target, up, f: float, width: int, height: int) -> Camera:
    """A pinhole camera at ``eye`` looking at ``target``, its fields rounded
    to float32 as a scan's calibration holds them."""
    eye = np.asarray(eye, np.float64)
    a = np.asarray(target, np.float64) - eye
    a = a / np.linalg.norm(a)
    n = np.cross(a, np.asarray(up, np.float64))
    n = n / np.linalg.norm(n)
    o = np.cross(a, n)
    f32 = np.float32
    return Camera(rotation=np.stack([n, o, a]).astype(f32), position=eye.astype(f32),
                  f=float(f32(f)), cx=float(f32((width - 1) / 2.0)),
                  cy=float(f32((height - 1) / 2.0)), sx=1.0, kappa1=0.0,
                  width=width, height=height)


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v = np.asarray(vertices, np.float64)
    n = np.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(norm > 0, n / np.where(norm > 0, norm, 1.0), 0.0)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Sum of the adjacent faces' unit normals, normalised per vertex."""
    fn = face_normals(vertices, faces)
    out = np.zeros((len(vertices), 3))
    for corner in range(3):
        np.add.at(out, faces[:, corner], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return np.where(norm > 0, out / np.where(norm > 0, norm, 1.0), 0.0)


def project(cam: Camera, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World points → (pixel coordinates (..., 2), camera depth (...))."""
    pc = (np.asarray(points, np.float64) - np.asarray(cam.position, np.float64)) \
        @ np.asarray(cam.rotation, np.float64).T
    z = pc[..., 2]
    inv_z = 1.0 / np.where(np.abs(z) > 1e-9, z, 1e-9)
    xu = float(cam.f) * pc[..., 0] * inv_z
    yu = float(cam.f) * pc[..., 1] * inv_z
    xd, yd = xu, yu
    for _ in range(3):
        s = 1.0 + float(cam.kappa1) * (xd * xd + yd * yd)
        xd, yd = xu / s, yu / s
    return np.stack([float(cam.cx) + float(cam.sx) * xd, float(cam.cy) + yd], -1), z


def rasterize(cam: Camera, vertices: np.ndarray, faces: np.ndarray) -> RasterMap:
    """Every face scan-converted over its bounding box, nearest hit kept."""
    h, w = cam.height, cam.width
    uv, z = project(cam, vertices)
    face_id = np.full((h, w), -1, np.int32)
    depth = np.full((h, w), np.inf, np.float32)
    bary = np.zeros((h, w, 3), np.float32)
    tri_uv, tri_z = uv[faces], z[faces]
    lo, hi = tri_uv.min(1), tri_uv.max(1)
    live = ((tri_z > 1e-6).all(1) & (hi[:, 0] >= 0) & (lo[:, 0] < w)
            & (hi[:, 1] >= 0) & (lo[:, 1] < h))
    for fi in np.nonzero(live)[0]:
        (x0, y0), (x1, y1), (x2, y2) = tri_uv[fi]
        px0, px1 = max(int(np.floor(lo[fi, 0])), 0), min(int(np.ceil(hi[fi, 0])), w - 1)
        py0, py1 = max(int(np.floor(lo[fi, 1])), 0), min(int(np.ceil(hi[fi, 1])), h - 1)
        if px1 < px0 or py1 < py0:
            continue
        d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(d) < 1e-12:
            continue
        inv_d = 1.0 / d
        cx = np.arange(px0, px1 + 1)[None, :] + 0.5
        cy = np.arange(py0, py1 + 1)[:, None] + 0.5
        b0 = ((y1 - y2) * (cx - x2) + (x2 - x1) * (cy - y2)) * inv_d
        b1 = ((y2 - y0) * (cx - x2) + (x0 - x2) * (cy - y2)) * inv_d
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        inv_z = b0 * (1.0 / tri_z[fi, 0]) + b1 * (1.0 / tri_z[fi, 1]) + b2 * (1.0 / tri_z[fi, 2])
        pz = (1.0 / np.maximum(inv_z, 1e-12)).astype(np.float32)
        sub = depth[py0:py1 + 1, px0:px1 + 1]
        near = inside & (pz < sub)
        if not near.any():
            continue
        sub[near] = pz[near]
        face_id[py0:py1 + 1, px0:px1 + 1][near] = fi
        bary[py0:py1 + 1, px0:px1 + 1][near] = np.stack(
            [b0[near], b1[near], b2[near]], -1).astype(np.float32)
    return RasterMap(face_id, bary, depth)


class Texels(NamedTuple):
    points: np.ndarray    # (T, 3)
    normals: np.ndarray   # (T, 3) unit
    face_ids: np.ndarray  # (T,)
    pixels: np.ndarray    # (T, 2) [x, y]


def pixel_texels(vertices, faces, vnormals, rm: RasterMap, stride: int = 1) -> Texels:
    """One texel per covered pixel (every ``stride``-th row and column),
    at the hit point, with the interpolated vertex normal."""
    cov = rm.face_id >= 0
    if stride > 1:
        keep = np.zeros_like(cov)
        keep[::stride, ::stride] = True
        cov &= keep
    ys, xs = np.nonzero(cov)
    fids = rm.face_id[ys, xs].astype(np.int64)
    b = rm.bary[ys, xs].astype(np.float64)
    corners = np.asarray(faces)[fids]
    pts = np.einsum("tk,tkd->td", b, np.asarray(vertices, np.float64)[corners])
    nrm = np.einsum("tk,tkd->td", b, np.asarray(vnormals, np.float64)[corners])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), EPS)
    return Texels(pts, nrm, fids, np.stack([xs, ys], -1))


def _bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    u = np.clip(u - 0.5, 0.0, w - 1.0)
    v = np.clip(v - 0.5, 0.0, h - 1.0)
    x0, y0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    fu, fv = (u - x0)[..., None], (v - y0)[..., None]
    return (img[y0, x0] * (1 - fu) * (1 - fv) + img[y0, x1] * fu * (1 - fv)
            + img[y1, x0] * (1 - fu) * fv + img[y1, x1] * fu * fv)


def sample_views(points, cams, rms, images, rel_tol=0.01, abs_tol=0.5):
    """Each texel measured in every view: bilinear at its projection, weight
    1 where the view's z-buffer agrees with its depth. → (T, V, 3), (T, V)."""
    t, nv = len(points), len(cams)
    intensity = np.zeros((t, nv, 3), np.float32)
    weights = np.zeros((t, nv), np.float32)
    for vi, (cam, rm) in enumerate(zip(cams, rms)):
        uv, z = project(cam, points)
        u, v = uv[:, 0], uv[:, 1]
        inside = (z > 1e-6) & (u >= 0) & (u <= cam.width - 1) & (v >= 0) & (v <= cam.height - 1)
        zbuf = rm.depth[np.clip(np.floor(v).astype(np.int64), 0, cam.height - 1),
                        np.clip(np.floor(u).astype(np.int64), 0, cam.width - 1)]
        tol = np.maximum(abs_tol, rel_tol * np.abs(z))
        weights[:, vi] = inside & np.isfinite(zbuf) & (np.abs(zbuf - z) <= tol)
        intensity[:, vi] = _bilinear(images[vi], u, v)
    return intensity, weights


def face_means(rm_list, images, n_faces: int):
    """Per face and view, the mean of the pixels it covers → visible faces,
    (T, V, 3) means, (T, V) weights (1 where the face is seen)."""
    nv = len(images)
    sums = np.zeros((nv, n_faces, 3))
    counts = np.zeros((nv, n_faces), np.int64)
    for vi, rm in enumerate(rm_list):
        cov = rm.face_id >= 0
        ids = rm.face_id[cov]
        img = images[vi][cov].astype(np.float64)
        for ch in range(3):
            sums[vi, :, ch] = np.bincount(ids, weights=img[:, ch], minlength=n_faces)
        counts[vi] = np.bincount(ids, minlength=n_faces)
    face_ids = np.nonzero(counts.sum(0) > 0)[0]
    c = counts[:, face_ids].T
    mean = (sums[:, face_ids].transpose(1, 0, 2) / np.maximum(c, 1)[..., None]).astype(np.float32)
    mean[c == 0] = 0.0
    return face_ids, mean, (c > 0).astype(np.float32)
