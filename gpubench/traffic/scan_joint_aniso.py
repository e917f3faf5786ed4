"""The anisotropic joint scan generator: ``traffic/scan.py``'s bumped sphere,
camera and 16-LED rig, rendered per face with the anisotropic GGX lobe
(``reference/joint_aniso.py``) under a tilted normal and per-view rig gains,
from a seed and a configuration's ``scan`` and ``truth`` sections.

Every pixel of a face takes the face's value at its centroid under its
normal tilted by a per-face offset in its tangent frame, with the material
axes of the tilted normal's own frame (``render: "tilted_faces"``, which the
m = 11 joint normal-map fit can reproduce); view v's radiance is multiplied
by the rig's gain g_v, then clipped to [0, 1] and quantised to ``bits`` as
``scan.py`` quantises. The seed draws per face kd and ks for each channel,
one (rough_x, rough_y, phi) and the tilt, and one gain a view (drawn
uniformly, then divided by their mean), so every seed gives the same sizes.
Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference import joint_aniso, lobes
from gpubench.traffic.scan import Scan, _rng, geometry


@dataclasses.dataclass
class GainScan(Scan):
    gains: np.ndarray | None = None   # (V,) the rig's gain a view, mean 1


def make_scan(config: dict, seed: int, index: int, device=None, images: bool = True) -> GainScan:
    """Scan ``index`` of the pool that ``seed`` draws for ``config``;
    ``params`` is (F, 3, 5): (kd, ks, rough_x, rough_y, phi) per face and
    channel, ``offsets`` (F, 2) the tilts (``images=False``: the geometry,
    parameters and gains alone)."""
    sc, truth = config["scan"], config["truth"]
    if sc["render"] != "tilted_faces":
        raise ValueError(f"the joint aniso scan renders 'tilted_faces' only, not {sc['render']!r}")
    g = geometry(sc["subdiv"], sc["width"], sc["height"], sc["views"])
    rng = _rng(seed, index)
    nf = len(g.faces)
    kd = rng.uniform(*truth["kd"], (nf, 3))
    ks = rng.uniform(*truth["ks"], (nf, 3))
    shape = np.stack([rng.uniform(*truth[k], nf) for k in ("rough_x", "rough_y", "phi")], -1)
    params = np.concatenate([np.stack([kd, ks], -1),
                             np.broadcast_to(shape[:, None, :], (nf, 3, 3))], -1).astype(np.float32)
    rad = truth["tilt"] * np.sqrt(rng.uniform(0.0, 1.0, nf))
    ang = rng.uniform(0.0, 2.0 * np.pi, nf)
    offsets = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32)
    gains = rng.uniform(*truth["gains"], len(g.lights))
    gains = gains / gains.mean()
    scan = GainScan(g, None, params, offsets, config["model"], gains)
    if images:
        scan.images = _render(g, sc, truth_params(scan), gains, device)
    return scan


def truth_params(scan: GainScan) -> np.ndarray:
    """The truth as the joint model's (F, 11) parameters."""
    p = scan.params
    return np.concatenate([p[:, :, 0], p[:, :, 1], p[:, 0, 2:5], scan.offsets], -1)


def _render(g, sc: dict, p11: np.ndarray, gains, device) -> np.ndarray:
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))

    def t64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    l, v = lobes.directions(t64(g.centroids), t64(g.camera.position), t64(g.lights))
    val = joint_aniso.joint_model(t64(g.face_normals), l, v, t64(p11)) * t64(gains)  # (F, 3, V)
    fid = g.raster.face_id
    cov = fid >= 0
    val = val.permute(0, 2, 1)[torch.as_tensor(fid[cov], device=dev)]          # (P, V, 3)
    levels = float(2 ** sc["bits"] - 1)
    q = (torch.round(torch.clamp(val, 0.0, 1.0) * levels) / levels).to(torch.float32).cpu().numpy()
    images = np.zeros((len(g.lights), g.camera.height, g.camera.width, 3), np.float32)
    rows = np.nonzero(cov)
    images[:, rows[0], rows[1]] = q.transpose(1, 0, 2)
    return images
