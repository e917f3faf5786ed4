# Copied from brdf_tpu/geometry/rasterize.py (host numpy; the port imports nothing of brdf_tpu).
"""Host-side z-buffered triangle rasterization: the pixel↔surface map.

Replaces ``CBRDFdata::CalcPixel2SurfaceMapping``
(``brdfdata.cpp:629-681``), which forward-projected each
triangle *centroid* through live GL matrices into a single pixel — no
coverage, no occlusion (so hidden faces overwrite visible ones), and only one
pixel per face. Here every triangle is projected through the explicit Tsai
camera, scan-converted over its bounding box with barycentric coverage, and
depth-tested, producing for every pixel: the visible face id, the barycentric
coordinates, and the depth.

This is deliberately a *host-side precompute* (NumPy): the map depends only on
the fixed scene geometry and camera, never on BRDF parameters, so it stays out
of the differentiated path (SURVEY.md §7 "Hard parts"). The inner loop is
vectorized over a face-major ordering with per-face bounding boxes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from brdf_tpu_torch.geometry.camera import Camera, project_np


class RasterMap(NamedTuple):
    face_id: np.ndarray   # (H, W) int32, -1 = background
    bary: np.ndarray      # (H, W, 3) float32 barycentric coords of the hit
    depth: np.ndarray     # (H, W) float32 camera-space z (inf = background)

    @property
    def coverage(self) -> np.ndarray:
        return self.face_id >= 0


def rasterize_mesh(
    camera: Camera, vertices: np.ndarray, faces: np.ndarray, native: bool = True
) -> RasterMap:
    """Rasterize a triangle mesh into the camera's pixel grid.

    Uses the C++ core (``csrc/rasterizer.cpp``, built on demand) when a
    toolchain is available; the NumPy path below is the reference version
    and what runs without one — both produce identical maps (tested)."""
    h, w = camera.height, camera.width
    verts = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)

    uv, z = project_np(camera, verts)

    face_id = np.full((h, w), -1, np.int32)
    depth = np.full((h, w), np.inf, np.float32)
    bary_out = np.zeros((h, w, 3), np.float32)

    if native:
        from brdf_tpu_torch import native as native_mod

        fn = native_mod.rasterizer_lib()
        if fn is not None:
            import ctypes

            uv_c = np.ascontiguousarray(uv, np.float64)
            z_c = np.ascontiguousarray(z, np.float64)
            f_c = np.ascontiguousarray(faces, np.int32)
            fn(
                uv_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                z_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                f_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(f_c), w, h,
                face_id.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                bary_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return RasterMap(face_id=face_id, bary=bary_out, depth=depth)

    tri_uv = uv[faces]       # (F, 3, 2)
    tri_z = z[faces]         # (F, 3)

    # cull faces entirely behind the camera or off screen
    in_front = (tri_z > 1e-6).all(axis=1)
    mins = tri_uv.min(axis=1)
    maxs = tri_uv.max(axis=1)
    on_screen = (maxs[:, 0] >= 0) & (mins[:, 0] < w) & (maxs[:, 1] >= 0) & (mins[:, 1] < h)
    live = np.nonzero(in_front & on_screen)[0]

    for fi in live:
        p0, p1, p2 = tri_uv[fi]
        x0 = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
        x1 = min(int(np.ceil(max(p0[0], p1[0], p2[0]))), w - 1)
        y0 = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
        y1 = min(int(np.ceil(max(p0[1], p1[1], p2[1]))), h - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs = np.arange(x0, x1 + 1) + 0.5
        ys = np.arange(y0, y1 + 1) + 0.5
        px, py = np.meshgrid(xs, ys)

        # barycentric via edge functions
        d = (p1[1] - p2[1]) * (p0[0] - p2[0]) + (p2[0] - p1[0]) * (p0[1] - p2[1])
        if abs(d) < 1e-12:
            continue
        b0 = ((p1[1] - p2[1]) * (px - p2[0]) + (p2[0] - p1[0]) * (py - p2[1])) / d
        b1 = ((p2[1] - p0[1]) * (px - p2[0]) + (p0[0] - p2[0]) * (py - p2[1])) / d
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue

        # perspective-correct depth: interpolate 1/z linearly in screen space
        inv_z = b0 / tri_z[fi, 0] + b1 / tri_z[fi, 1] + b2 / tri_z[fi, 2]
        pix_z = 1.0 / np.maximum(inv_z, 1e-12)

        sub_depth = depth[y0 : y1 + 1, x0 : x1 + 1]
        closer = inside & (pix_z < sub_depth)
        if not closer.any():
            continue
        sub_depth[closer] = pix_z[closer].astype(np.float32)
        face_id[y0 : y1 + 1, x0 : x1 + 1][closer] = fi
        sub_bary = bary_out[y0 : y1 + 1, x0 : x1 + 1]
        sub_bary[closer] = np.stack(
            [b0[closer], b1[closer], b2[closer]], axis=-1
        ).astype(np.float32)

    return RasterMap(face_id=face_id, bary=bary_out, depth=depth)


def centroid_projection_map(camera: Camera, vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """The reference's crude mapping for comparison/diagnostics: project each
    face centroid to one pixel (no coverage, no depth test) —
    ``brdfdata.cpp:639-678`` semantics, minus the GL dependency."""
    h, w = camera.height, camera.width
    cent = np.asarray(vertices, np.float64)[np.asarray(faces)].mean(axis=1)
    uv, z = project_np(camera, cent)
    face_map = np.full((h, w), -1, np.int32)
    for fi in range(len(cent)):
        x, y = int(uv[fi, 0]), int(uv[fi, 1])
        if 0 <= x < w and 0 <= y < h and z[fi] > 0:
            face_map[y, x] = fi
    return face_map
