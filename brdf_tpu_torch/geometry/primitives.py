# Copied from brdf_tpu/geometry/primitives.py (host numpy; the port imports nothing of brdf_tpu).
"""Procedural test meshes (host-side NumPy).

The reference has no synthetic geometry (it only loads scanner OBJs); these
primitives exist for closed-loop tests and benchmarks: render images from
known parameters on a known mesh, then fit them back (SURVEY.md §4's
``expfit.c`` pattern extended through the full raster/render path).
"""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 2, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron: returns ``(vertices (V,3), faces (F,3) int32)``."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    verts = verts * radius + np.asarray(center, dtype=np.float64)
    return verts, faces.astype(np.int32)


def plane(size: float = 1.0, center=(0.0, 0.0, 0.0), resolution: int = 1):
    """A z-facing square grid of triangles."""
    xs = np.linspace(-size / 2, size / 2, resolution + 1)
    xx, yy = np.meshgrid(xs, xs, indexing="xy")
    verts = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], axis=-1)
    faces = []
    n = resolution + 1
    for r in range(resolution):
        for c in range(resolution):
            i = r * n + c
            faces.append([i, i + 1, i + n])
            faces.append([i + 1, i + n + 1, i + n])
    verts = verts + np.asarray(center, dtype=np.float64)
    return verts, np.asarray(faces, dtype=np.int32)
