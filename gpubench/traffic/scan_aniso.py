"""The anisotropic scan generator: ``traffic/scan.py``'s bumped sphere,
camera and 16-LED rig, rendered with the anisotropic Ward lobe
(``reference/ward_aniso.py``) from a seed and a configuration's ``scan``
and ``truth`` sections.

Every covered pixel is rendered at its hit point with the interpolated
vertex normal, that normal's tangent frame and its face's parameters
(``render: "smooth"``, which a pixel fit can reproduce), and quantised to
``bits`` as ``scan.py`` quantises. The seed draws per face kd and ks for
each channel and one (alpha_x, alpha_y, phi), so every seed gives the same
sizes. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import geometry as geo
from gpubench.reference import ward_aniso
from gpubench.traffic.scan import Scan, _rng, geometry


def make_scan(config: dict, seed: int, index: int, device=None, images: bool = True) -> Scan:
    """Scan ``index`` of the pool that ``seed`` draws for ``config``;
    ``params`` is (F, 3, 5): (kd, ks, alpha_x, alpha_y, phi) per face and
    channel (``images=False``: the geometry and parameters alone)."""
    sc, truth = config["scan"], config["truth"]
    if sc["render"] != "smooth":
        raise ValueError(f"the aniso scan renders 'smooth' only, not {sc['render']!r}")
    g = geometry(sc["subdiv"], sc["width"], sc["height"], sc["views"])
    rng = _rng(seed, index)
    nf = len(g.faces)
    kd = rng.uniform(*truth["kd"], (nf, 3))
    ks = rng.uniform(*truth["ks"], (nf, 3))
    shape = np.stack([rng.uniform(*truth[k], nf) for k in ("alpha_x", "alpha_y", "phi")], -1)
    params = np.concatenate([np.stack([kd, ks], -1),
                             np.broadcast_to(shape[:, None, :], (nf, 3, 3))], -1).astype(np.float32)
    stack = _render(g, sc, params, device) if images else None
    return Scan(g, stack, params, None, config["model"])


def _render(g, sc: dict, params: np.ndarray, device) -> np.ndarray:
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))

    def t64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    tex = geo.pixel_texels(g.vertices, g.faces, g.vertex_normals, g.raster)
    c = ward_aniso.cosines(t64(tex.points), t64(tex.normals), t64(g.camera.position),
                           t64(g.lights))
    val = ward_aniso.texel_model(c, t64(params[tex.face_ids])).permute(0, 2, 1)   # (T, V, 3)
    levels = float(2 ** sc["bits"] - 1)
    q = (torch.round(torch.clamp(val, 0.0, 1.0) * levels) / levels).to(torch.float32).cpu().numpy()
    images = np.zeros((len(g.lights), g.camera.height, g.camera.width, 3), np.float32)
    images[:, tex.pixels[:, 1], tex.pixels[:, 0]] = q.transpose(1, 0, 2)
    return images
