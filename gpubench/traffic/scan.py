"""The scan generator: a synthetic scan in the reference datasets' shape,
made from a seed and a configuration's ``scan`` and ``truth`` sections.

A bumped sphere of ``20·4^subdiv`` faces in front of the 16-LED cylinder rig
(``brdfdata.cpp:747-795``), one camera for every view, and per view the
dark-subtracted radiance quantised to ``bits`` (what a loader hands the
fit). The images are rendered with ``reference/lobes.py``:

- ``render: "smooth"`` — every covered pixel at its hit point with the
  interpolated vertex normal and its face's parameters (a pixel fit can
  reproduce it);
- ``render: "tilted_faces"`` — every pixel of a face with the face's value
  at its centroid, under its normal tilted by a per-face offset in its
  tangent frame (a joint normal-map fit can reproduce it);
- ``render: "none"`` — geometry and parameters only (relighting reads no
  image).

The geometry is the same for every seed; the seed draws the parameters (and
the tilts), so every seed gives the same sizes. Rewritten from the
program's ``tools/synthetic_scene.py``; imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gpubench.reference import geometry as geo
from gpubench.reference import lobes

CENTER = (0.0, 150.0, 120.0)
RADIUS = 30.0
EYE = (0.0, 150.0, 320.0)


def icosphere(subdiv: int):
    """Unit icosphere: vertices (N, 3) float64, faces (F, 3) int32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                      [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                      [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                      [8, 6, 7], [9, 8, 1]], np.int64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(subdiv):
        mids: dict = {}
        vl = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = vl[a] + vl[b]
                mids[key] = len(vl)
                vl.append(m / np.linalg.norm(m))
            return mids[key]

        new = []
        for a, b, c in faces.tolist():
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.asarray(vl), np.asarray(new, np.int64)
    return verts, faces.astype(np.int32)


def led_rig() -> np.ndarray:
    """The 16-LED cylinder rig (mm): rings at heights 365/260/150/45 − 115,
    azimuths {6, 13, 20, 27}/33 · π/2 on a radius of 305."""
    i = np.arange(16)
    y = np.array([365.0, 260.0, 150.0, 45.0])[i // 4] - 115.0
    a = np.array([6.0, 13.0, 20.0, 27.0])[i % 4] / 33.0 * np.pi * 0.5
    return np.stack([305.0 * np.sin(a), y, 305.0 * np.cos(a)], -1)


@dataclasses.dataclass
class Geometry:
    """What every scan of one ``scan`` section shares; float32 as a scan
    file holds it, normals and centroids rounded as a reader keeps them."""

    vertices: np.ndarray      # (N, 3) float32
    faces: np.ndarray         # (F, 3) int32
    camera: geo.Camera
    lights: np.ndarray        # (V, 3) float64
    raster: geo.RasterMap     # the camera's map (every view shares the camera)
    face_normals: np.ndarray  # (F, 3) float32
    vertex_normals: np.ndarray
    centroids: np.ndarray     # (F, 3) float32


def _rotation(a: float, b: float, c: float) -> np.ndarray:
    ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rz @ ry @ rx


@functools.lru_cache(maxsize=4)
def geometry(subdiv: int, width: int, height: int, views: int) -> Geometry:
    v, f = icosphere(subdiv)
    # a fixed, generic orientation: no vertex on the camera's axis planes, so
    # no pixel centre falls on an edge by symmetry
    d = v / np.linalg.norm(v, axis=-1, keepdims=True) @ _rotation(0.37, 0.61, 0.23).T
    bump = np.sin(5.0 * d[:, 0]) * np.sin(4.0 * d[:, 1] + 0.5) * np.cos(3.0 * d[:, 2])
    verts = (d * (RADIUS * (1.0 + 0.06 * bump))[:, None] + np.asarray(CENTER)).astype(np.float32)
    # the focal length that puts the sphere's diameter over 60% of the height
    cam = geo.look_at(EYE, CENTER, (0.0, 1.0, 0.0), 0.3 * height * (EYE[2] - CENTER[2]) / RADIUS,
                      width, height)
    v64 = verts.astype(np.float64)
    return Geometry(
        vertices=verts, faces=f, camera=cam, lights=led_rig()[:views],
        raster=geo.rasterize(cam, verts, f),
        face_normals=geo.face_normals(v64, f).astype(np.float32),
        vertex_normals=geo.vertex_normals(v64, f).astype(np.float32),
        centroids=v64[f].mean(axis=1).astype(np.float32))


@dataclasses.dataclass
class Scan:
    geometry: Geometry
    images: np.ndarray | None   # (V, H, W, 3) float32 in [0, 1]
    params: np.ndarray          # (F, 3, 3) per-face, per-channel (kd, ks, shape)
    offsets: np.ndarray | None  # (F, 2) the tilts of "tilted_faces"
    model: str


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, index]))


def make_scan(config: dict, seed: int, index: int, device=None, images: bool = True) -> Scan:
    """Scan ``index`` of the pool that ``seed`` draws for ``config``
    (``images=False``: the geometry and parameters alone)."""
    sc, truth, model = config["scan"], config["truth"], config["model"]
    g = geometry(sc["subdiv"], sc["width"], sc["height"], sc["views"])
    rng = _rng(seed, index)
    nf = len(g.faces)
    kd = rng.uniform(*truth["kd"], (nf, 3))
    ks = rng.uniform(*truth["ks"], (nf, 3))
    shape = rng.uniform(*truth["shape"], (nf, 1 if truth.get("shared_shape") else 3))
    params = np.stack([kd, ks, np.broadcast_to(shape, (nf, 3))], -1).astype(np.float32)
    offsets = None
    if sc["render"] == "tilted_faces":
        rad = truth["tilt"] * np.sqrt(rng.uniform(0.0, 1.0, nf))
        ang = rng.uniform(0.0, 2.0 * np.pi, nf)
        offsets = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32)
    stack = _render(g, sc, model, params, offsets, device) if images and sc["render"] != "none" \
        else None
    return Scan(g, stack, params, offsets, model)


def _render(g: Geometry, sc: dict, model: str, params, offsets, device) -> np.ndarray:
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))

    def t64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    eye, lights = t64(g.camera.position), t64(g.lights)
    lobe = lobes.LOBES[model]
    fid = g.raster.face_id
    cov = fid >= 0
    if sc["render"] == "smooth":
        tex = geo.pixel_texels(g.vertices, g.faces, g.vertex_normals, g.raster)
        c = lobes.cosines(t64(tex.points), t64(tex.normals), eye, lights)
        p = t64(params[tex.face_ids])                       # (T, 3, 3)
        val = torch.stack([lobe(p[:, ch, 0:1], p[:, ch, 1:2], p[:, ch, 2:3], c)
                           for ch in range(3)], -1)        # (T, V, 3)
        rows = (tex.pixels[:, 1], tex.pixels[:, 0])
    elif sc["render"] == "tilted_faces":
        n = lobes.tilted(t64(g.face_normals), t64(offsets[:, 0]), t64(offsets[:, 1]))
        c = lobes.cosines(t64(g.centroids), n, eye, lights)
        p = t64(params)
        val = torch.stack([lobe(p[:, ch, 0:1], p[:, ch, 1:2], p[:, ch, 2:3], c)
                           for ch in range(3)], -1)[fid[cov]]
        rows = np.nonzero(cov)
    else:
        raise ValueError(f"unknown render {sc['render']!r}")
    levels = float(2 ** sc["bits"] - 1)
    q = (torch.round(torch.clamp(val, 0.0, 1.0) * levels) / levels).to(torch.float32).cpu().numpy()
    images = np.zeros((len(g.lights), g.camera.height, g.camera.width, 3), np.float32)
    images[:, rows[0], rows[1]] = q.transpose(1, 0, 2)
    return images
