# Adapted from brdf_tpu/geometry/camera.py (the port imports nothing of brdf_tpu).
"""Tsai camera model: projection, rays, frustum math.

Replaces the reference's camera handling, which was split between the ``.cal``
parser (``brdfdata.cpp:149-247``), the principal-point-shifted
``glFrustum`` (``glutcallbacks.cpp:626-642``) and live-GL ``gluProject`` calls
(``brdfdata.cpp:629-681``). Here the whole model is explicit, differentiable
math — and the radial distortion ``kappa1``, which the reference parsed but
dropped, is honored.

Conventions:
- World→camera: ``x_c = R (x_w - p)`` with ``R`` rows = calibrated axes
  ``(n, o, a)`` (unit, mutually orthogonal; ``brdfdata.h:63-69``).
- Image coordinates: ``u`` to the right, ``v`` **down** (row index), origin at
  the top-left pixel center; ``z_c > 0`` in front of the camera.
- Tsai projection: undistorted sensor coords ``Xu = f·x_c/z_c``,
  ``Yu = f·y_c/z_c``; radial distortion ``Xu = Xd (1 + kappa1 r²)`` with
  ``r² = Xd² + Yd²``; pixel ``u = cx + sx·Xd``, ``v = cy + Yd``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.io.cal import TsaiCalibration


class Camera(NamedTuple):
    """Fields are host NumPy arrays, as ``TriangleMesh``'s are: rasterization
    and view sampling read them on the host (:func:`project_np`). The tensor
    methods below take points on any device and in any float dtype; the
    camera's constants follow the points there, and the methods are
    differentiable to the points."""

    rotation: np.ndarray  # (3, 3) world→camera; rows are camera axes in world
    position: np.ndarray  # (3,) camera center in world coords
    f: np.ndarray         # focal length (pixels)
    cx: np.ndarray
    cy: np.ndarray
    sx: np.ndarray        # horizontal scale factor
    kappa1: np.ndarray    # radial distortion
    width: int             # static — image width in pixels
    height: int            # static — image height in pixels

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_calibration(
        cls, cal: TsaiCalibration, width: int, height: int, dtype=np.float32
    ) -> "Camera":
        return cls(
            rotation=np.asarray(cal.rotation, dtype=dtype),
            position=np.asarray(cal.p, dtype=dtype),
            f=np.asarray(cal.f, dtype=dtype),
            cx=np.asarray(cal.cx, dtype=dtype),
            cy=np.asarray(cal.cy, dtype=dtype),
            sx=np.asarray(cal.sx, dtype=dtype),
            kappa1=np.asarray(cal.kappa1, dtype=dtype),
            width=width,
            height=height,
        )

    @classmethod
    def look_at(
        cls,
        eye,
        target,
        up=(0.0, 1.0, 0.0),
        f: float = 500.0,
        width: int = 256,
        height: int = 256,
        dtype=np.float32,
    ) -> "Camera":
        """Synthetic pinhole camera looking from ``eye`` at ``target``."""
        eye = np.asarray(eye, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        a = target - eye
        a = a / np.linalg.norm(a)                      # optical axis
        n = np.cross(a, up)                            # right (+u)
        n = n / np.linalg.norm(n)
        o = np.cross(a, n)                             # down (+v), so v grows downward
        rot = np.stack([n, o, a], axis=0)
        return cls(
            rotation=np.asarray(rot, dtype=dtype),
            position=np.asarray(eye, dtype=dtype),
            f=np.asarray(f, dtype=dtype),
            cx=np.asarray((width - 1) / 2.0, dtype=dtype),
            cy=np.asarray((height - 1) / 2.0, dtype=dtype),
            sx=np.asarray(1.0, dtype=dtype),
            kappa1=np.asarray(0.0, dtype=dtype),
            width=width,
            height=height,
        )

    # -- transforms --------------------------------------------------------

    def _on(self, like: torch.Tensor, *fields: str):
        """The named fields as tensors of ``like``'s dtype on its device."""
        return tuple(torch.as_tensor(np.asarray(getattr(self, name)), dtype=like.dtype,
                                     device=like.device) for name in fields)

    def world_to_camera(self, points: torch.Tensor) -> torch.Tensor:
        """(…, 3) world points → camera coords."""
        position, rotation = self._on(points, "position", "rotation")
        return (points - position) @ rotation.T

    def project(self, points: torch.Tensor, eps: float = 1e-9):
        """Project world points to pixel coords.

        Returns ``(uv, depth)``: ``uv`` is (…, 2) with ``u`` = column,
        ``v`` = row (down); ``depth`` is camera-space z (positive in front).
        """
        f, cx, cy, sx, kappa1 = self._on(points, "f", "cx", "cy", "sx", "kappa1")
        pc = self.world_to_camera(points)
        z = pc[..., 2]
        inv_z = 1.0 / torch.where(z.abs() > eps, z, torch.full_like(z, eps))
        xu = f * pc[..., 0] * inv_z
        yu = f * pc[..., 1] * inv_z
        xd, yd = _distort(xu, yu, kappa1)
        u = cx + sx * xd
        v = cy + yd
        return torch.stack([u, v], dim=-1), z

    def pixel_rays(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel coords (…, 2) → world-space unit ray directions from the
        camera center (undoing radial distortion)."""
        f, cx, cy, sx, kappa1, rotation = self._on(uv, "f", "cx", "cy", "sx", "kappa1", "rotation")
        xd = (uv[..., 0] - cx) / sx
        yd = uv[..., 1] - cy
        r2 = xd * xd + yd * yd
        scale = 1.0 + kappa1 * r2
        xu = xd * scale
        yu = yd * scale
        d_cam = torch.stack([xu / f, yu / f, torch.ones_like(xu)], dim=-1)
        d_world = d_cam @ rotation  # R^T d
        return d_world / torch.linalg.vector_norm(d_world, dim=-1, keepdim=True)

    def frustum_params(self, near: float, far: float):
        """Asymmetric frustum ``(l, r, b, t, n, f)`` honoring the principal
        point — the same construction as ``MakeFrustum``
        (``glutcallbacks.cpp:626-642``) but derived from intrinsics directly."""
        half_w = near * self.width / (2.0 * self.f * self.sx)
        half_h = near * self.height / (2.0 * self.f)
        off_x = 2.0 * (self.width / 2.0 - self.cx) / self.width * half_w
        off_y = 2.0 * (self.height / 2.0 - self.cy) / self.height * half_h
        return (
            -half_w + off_x,
            half_w + off_x,
            -half_h - off_y,
            half_h - off_y,
            near,
            far,
        )


def project_np(camera: Camera, points: np.ndarray):
    """NumPy mirror of :meth:`Camera.project` for host-side precompute
    (rasterization, view sampling), in float64. Kept in lockstep with the
    tensor version (tested)."""
    rot = np.asarray(camera.rotation, np.float64)
    pos = np.asarray(camera.position, np.float64)
    f = float(camera.f)
    cx, cy = float(camera.cx), float(camera.cy)
    sx = float(camera.sx)
    kappa1 = float(camera.kappa1)

    pc = (np.asarray(points, np.float64) - pos) @ rot.T
    z = pc[..., 2]
    inv_z = 1.0 / np.where(np.abs(z) > 1e-9, z, 1e-9)
    xu = f * pc[..., 0] * inv_z
    yu = f * pc[..., 1] * inv_z
    xd, yd = xu, yu
    for _ in range(3):
        r2 = xd * xd + yd * yd
        s = 1.0 + kappa1 * r2
        xd, yd = xu / s, yu / s
    u = cx + sx * xd
    v = cy + yd
    return np.stack([u, v], axis=-1), z


def _distort(xu: torch.Tensor, yu: torch.Tensor, kappa1) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert ``Xu = Xd (1 + kappa1 r²)`` for ``Xd`` by fixed-point iteration.

    kappa1·r² is ≲1e-2 for calibrations of the reference rig (1.66e-8 for its
    cup scene), so three iterations converge far below float32 eps.
    """
    xd, yd = xu, yu
    for _ in range(3):
        r2 = xd * xd + yd * yd
        s = 1.0 + kappa1 * r2
        xd, yd = xu / s, yu / s
    return xd, yd
