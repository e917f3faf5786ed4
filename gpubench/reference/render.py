"""The relit image worked out again: every covered pixel of the camera's
raster map at its hit point, with the interpolated vertex normal and its
face's parameters, lit by the given lights and summed over them; pixels
of no face are 0."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import geometry as geo
from gpubench.reference import lobes


def relight(g, model: str, params: np.ndarray, lights: np.ndarray, device,
            shade_dtype=torch.float64) -> np.ndarray:
    """The (H, W, 3) image of geometry ``g`` under ``lights`` (L, 3). The
    geometry is worked out in float64; the lobe runs in ``shade_dtype``."""
    tex = geo.pixel_texels(g.vertices, g.faces,
                           geo.vertex_normals(g.vertices.astype(np.float64), g.faces), g.raster)

    def t64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    c = lobes.cosines(t64(tex.points), t64(tex.normals), t64(g.camera.position), t64(lights))
    c = {k: v.to(shade_dtype)[:, None, :] for k, v in c.items()}
    p = t64(params[tex.face_ids]).to(shade_dtype)                     # (N, 3, 3)
    val = lobes.LOBES[model](p[..., 0:1], p[..., 1:2], p[..., 2:3], c).sum(-1)   # (N, 3)
    img = np.zeros((g.camera.height, g.camera.width, 3), np.float64)
    img[tex.pixels[:, 1], tex.pixels[:, 0]] = val.double().cpu().numpy()
    return img
