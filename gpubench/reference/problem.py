"""The fit problem worked out again from a scan: texels, their cosines in
every view, the measured intensities and the base weights (seen, and below
the sensor's ceiling where the configuration masks saturation).

A pixel problem has one texel per covered pixel of the reference view and
is fitted per channel; a face problem has one texel per face that some view
sees, its per-view mean over the face's pixels, and the face's centroid
and normal (the joint fit tilts that normal).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference import geometry as geo

SATURATION = 0.98


@dataclasses.dataclass
class Problem:
    keys: np.ndarray        # (T,) texel key: y·W + x for pixels, the face id for faces
    points: np.ndarray      # (T, 3) float64
    normals: np.ndarray     # (T, 3) float64
    intensity: np.ndarray   # (T, V, 3) float32
    seen: np.ndarray        # (T, V) float32, 1 where the view sees the texel
    weights: np.ndarray     # (T, V, 3) float32 base weights per channel
    eye: np.ndarray         # (3,)
    lights: np.ndarray      # (V, 3)


def build(scan, config: dict) -> Problem:
    g = scan.geometry
    views = len(g.lights)
    if config["granularity"] == "pixel":
        # every view shares the scan's one camera, so the reference view's map is g.raster
        tex = geo.pixel_texels(g.vertices, g.faces, geo.vertex_normals(
            g.vertices.astype(np.float64), g.faces), g.raster, config.get("pixel_stride", 1))
        inten, seen = geo.sample_views(tex.points, [g.camera] * views, [g.raster] * views,
                                       scan.images)
        keys = tex.pixels[:, 1].astype(np.int64) * g.camera.width + tex.pixels[:, 0]
        points, normals = tex.points, tex.normals
    else:
        face_ids, inten, seen = geo.face_means([g.raster] * views, scan.images, len(g.faces))
        keys = face_ids.astype(np.int64)
        points = g.centroids[face_ids].astype(np.float64)
        normals = g.face_normals[face_ids].astype(np.float64)
    w = np.repeat(seen[..., None], 3, -1)
    if config["solver"].get("mask_saturation", True):
        w = w * (inten < SATURATION)
    return Problem(keys, points, normals, inten, seen, w.astype(np.float32),
                   np.asarray(g.camera.position, np.float64), np.asarray(g.lights, np.float64))


def tensors(problem: Problem, device, dtype=torch.float64):
    """points, normals, eye, lights, intensity (T, V, 3), weights on ``device``."""
    return tuple(torch.as_tensor(np.asarray(x), device=device).to(dtype)
                 for x in (problem.points, problem.normals, problem.eye, problem.lights,
                           problem.intensity, problem.weights))
