# Copied from brdf_tpu/io/obj.py (host numpy; the port imports nothing of brdf_tpu).
"""Wavefront OBJ loading (host-side, NumPy).

Replaces the reference's ``CBRDFdata::LoadModel`` (libigl ``readOBJ``,
``brdfdata.cpp:289-312``). Pure NumPy — mesh loading is a
host-side, one-time cost and never appears inside a jitted computation.

Handles the DAVID-laser-scanner export format shipped with the reference
datasets (``v x y z`` + ``f i/i j/j k/k``) as well as general ``f`` lines with
texture/normal slots and negative (relative) indices.
"""

from __future__ import annotations

import numpy as np


def _parse_face_vertex(token: str, n_vertices: int) -> int:
    """Return a 0-based vertex index from an OBJ face token like ``12/4/7``."""
    idx = int(token.split("/", 1)[0])
    if idx < 0:  # relative index
        idx = n_vertices + idx
    else:
        idx = idx - 1
    return idx


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file.

    Returns:
      ``(vertices, faces)`` — ``vertices`` is ``(V, 3) float64``, ``faces`` is
      ``(F, 3) int32`` (triangles; polygons are fan-triangulated).
    """
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                toks = line.split()[1:]
                idx = [_parse_face_vertex(t, len(verts)) for t in toks]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    vertices = np.asarray(verts, dtype=np.float64)
    faces_arr = np.asarray(faces, dtype=np.int32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"no vertices parsed from {path!r}")
    if faces_arr.size and faces_arr.max() >= len(vertices):
        raise ValueError(f"face index out of range in {path!r}")
    return vertices, faces_arr


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit per-face normals via the edge cross product.

    Matches the *intent* of ``CalcFaceNormals`` (``brdfdata.cpp:314-330``);
    degenerate faces get a zero normal instead of NaN.
    """
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(norm > 0, n / np.where(norm > 0, norm, 1.0), 0.0)


def vertex_normals(
    vertices: np.ndarray, faces: np.ndarray, fnormals: np.ndarray | None = None
) -> np.ndarray:
    """Area-weighted per-vertex normals, normalized **per row**.

    The reference's ``CalcVertexNormals`` (``brdfdata.cpp:332-366``) averages
    adjacent face normals through a multimap and then erroneously normalizes
    the whole matrix rather than each row (``brdfdata.cpp:362``) — here each
    vertex normal is a proper unit vector.
    """
    if fnormals is None:
        fnormals = face_normals(vertices, faces)
    out = np.zeros_like(vertices)
    for j in range(3):
        np.add.at(out, faces[:, j], fnormals)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return np.where(norm > 0, out / np.where(norm > 0, norm, 1.0), 0.0)
