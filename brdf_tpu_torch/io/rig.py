# Copied from brdf_tpu/io/rig.py (host numpy; the port imports nothing of brdf_tpu).
"""Light-rig geometry.

The reference hard-codes measured 3D positions of its 16-LED capture rig in
``CBRDFdata::InitLEDs`` (the reference app's ``brdfdata.cpp:683-797``). Two rigs
appear there:

- the **active** code: a planar 4×4 serpentine grid at x=303.5,
  y∈[-157.1,-2.3], z∈[555.3,645.8] (``brdfdata.cpp:705-745``);
- a **commented-out** cylindrical arc rig matching the measurement notes in
  the comments ("radius 30.5cm, heights 36.5/26/15/4.5cm, origin z=11.5cm"):
  ring ``i//4`` sets height y = {365,260,150,45}−115, position ``i%4`` sets
  azimuth a = {6,13,20,27}/33·π/2 with x=305·sin(a), z=305·cos(a)
  (``brdfdata.cpp:747-795``).

Empirically the *cylindrical* rig is the one the shipped datasets were
captured with: per-face correlation between ⟨N·L⟩ and measured intensity on
the cup dataset is ≈0.86 for the cylinder vs ≈0.02 for the active grid — the
active code simply doesn't match its own data. The cylinder is therefore the
default here; the grid remains available as ``variant="grid"``.

Positions are measured *data* about the physical rig; any (L, 3) array is a
valid rig, and helpers build parametric rigs for synthetic scenes.
"""

from __future__ import annotations

import numpy as np

# planar-grid envelope (mm) from the active code path, brdfdata.cpp:695-703
_X = 303.5
_MIN_Y, _MAX_Y = -157.1, -2.3
_MIN_Z, _MAX_Z = 555.3, 645.8

# cylindrical rig constants from the measurement comments + commented code,
# brdfdata.cpp:685-691, 747-795
_CYL_RADIUS = 305.0
_CYL_HEIGHTS = (365.0, 260.0, 150.0, 45.0)   # mm, per ring of 4
_CYL_ORIGIN_Y = 115.0
_CYL_AZIMUTH_STEPS = (6.0, 13.0, 20.0, 27.0)  # /33 · π/2


def led_rig_positions(variant: str = "cylinder") -> np.ndarray:
    """The measured 16-LED rig, ``(16, 3) float64``.

    ``variant="cylinder"`` (default): the arc rig the datasets match.
    ``variant="grid"``: the planar serpentine grid from the reference's active
    code path.
    """
    if variant == "cylinder":
        led = np.zeros((16, 3), dtype=np.float64)
        for i in range(16):
            y = _CYL_HEIGHTS[i // 4] - _CYL_ORIGIN_Y
            a = _CYL_AZIMUTH_STEPS[i % 4] / 33.0 * np.pi * 0.5
            led[i] = (_CYL_RADIUS * np.sin(a), y, _CYL_RADIUS * np.cos(a))
        return led
    if variant == "grid":
        y_step = (_MAX_Y - _MIN_Y) / 3.0
        z_step = (_MAX_Z - _MIN_Z) / 3.0
        ys = np.array([_MAX_Y, _MAX_Y - y_step, _MIN_Y + y_step, _MIN_Y])
        zs = np.array([_MIN_Z, _MIN_Z + z_step, _MAX_Z - z_step, _MAX_Z])
        led = np.zeros((16, 3), dtype=np.float64)
        led[:, 0] = _X
        for i in range(16):
            ring, pos = divmod(i, 4)
            # serpentine: odd rings run the y sequence in reverse
            y_idx = pos if ring % 2 == 0 else 3 - pos
            led[i, 1] = ys[y_idx]
            led[i, 2] = zs[ring]
        return led
    raise ValueError(f"unknown rig variant {variant!r}")


def ring_rig(
    num_lights: int,
    radius: float,
    height: float = 0.0,
    center: np.ndarray | None = None,
    axis: str = "y",
) -> np.ndarray:
    """A parametric ring of ``num_lights`` point lights (synthetic scenes)."""
    if center is None:
        center = np.zeros(3)
    theta = np.linspace(0.0, 2.0 * np.pi, num_lights, endpoint=False)
    c, s = np.cos(theta), np.sin(theta)
    if axis == "y":
        pts = np.stack([radius * c, np.full_like(c, height), radius * s], axis=-1)
    elif axis == "z":
        pts = np.stack([radius * c, radius * s, np.full_like(c, height)], axis=-1)
    else:
        pts = np.stack([np.full_like(c, height), radius * c, radius * s], axis=-1)
    return pts + np.asarray(center)[None]


def grid_rig(
    rows: int,
    cols: int,
    y_range: tuple[float, float],
    z_range: tuple[float, float],
    x: float,
) -> np.ndarray:
    """A planar serpentine grid rig like the reference's, any size."""
    ys = np.linspace(y_range[1], y_range[0], cols)
    zs = np.linspace(z_range[0], z_range[1], rows)
    out = np.zeros((rows * cols, 3), dtype=np.float64)
    for i in range(rows * cols):
        ring, pos = divmod(i, cols)
        y_idx = pos if ring % 2 == 0 else cols - 1 - pos
        out[i] = (x, ys[y_idx], zs[ring])
    return out
