# Copied from brdf_tpu/geometry/mesh.py (host numpy; the dtype defaults are numpy's; the port imports nothing of brdf_tpu).
"""Triangle-mesh container (host side).

Replaces the mesh side of ``CBRDFdata`` (Eigen ``m_vertices``/``m_faces`` plus
``CalcFaceNormals``/``CalcVertexNormals``, ``brdfdata.cpp:289-366``)
with an immutable NamedTuple of **host NumPy arrays**. Problem building
(rasterization, per-face gathers, angle precompute) is host work; mesh
quantities reach the device only as the gathered per-pixel or per-texel
arrays that the fit and the renderer upload.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from brdf_tpu_torch.io import obj as obj_io


class TriangleMesh(NamedTuple):
    """An indexed triangle mesh with precomputed shading geometry.

    All arrays are host NumPy; ``faces`` is integer
    and is never differentiated through.
    """

    vertices: np.ndarray        # (V, 3)
    faces: np.ndarray           # (F, 3) int32
    face_normals: np.ndarray    # (F, 3) unit
    vertex_normals: np.ndarray  # (V, 3) unit
    centroids: np.ndarray       # (F, 3) triangle centers

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @classmethod
    def from_arrays(cls, vertices, faces, dtype=np.float32) -> "TriangleMesh":
        vertices = np.asarray(vertices, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int32)
        fn = obj_io.face_normals(vertices, faces)
        vn = obj_io.vertex_normals(vertices, faces, fn)
        centroids = vertices[faces].mean(axis=1)
        return cls(
            vertices=np.asarray(vertices, dtype=dtype),
            faces=faces,
            face_normals=np.asarray(fn, dtype=dtype),
            vertex_normals=np.asarray(vn, dtype=dtype),
            centroids=np.asarray(centroids, dtype=dtype),
        )

    @classmethod
    def from_obj(cls, path: str, dtype=np.float32) -> "TriangleMesh":
        vertices, faces = obj_io.load_obj(path)
        return cls.from_arrays(vertices, faces, dtype=dtype)

    def scaled(self, factor: float) -> "TriangleMesh":
        """Uniformly rescale positions (normals unchanged). The reference had a
        (disabled) ``ScaleMesh``, ``brdfdata.cpp:273-287``."""
        return self._replace(
            vertices=self.vertices * factor, centroids=self.centroids * factor
        )

    def centered(self) -> "TriangleMesh":
        offset = (self.vertices.max(axis=0) + self.vertices.min(axis=0)) / 2.0
        return self._replace(
            vertices=self.vertices - offset, centroids=self.centroids - offset
        )
