"""Meshes, cameras, rasterization and texelization (host numpy)."""

from brdf_tpu_torch.geometry.mesh import TriangleMesh  # noqa: F401
from brdf_tpu_torch.geometry.camera import Camera  # noqa: F401
