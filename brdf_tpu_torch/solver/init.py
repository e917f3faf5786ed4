"""Linearized grid initialization for lobe fits.

Port of ``brdf_tpu/solver/init.py``: every lobe is linear in its leading
``ModelSpec.linear`` parameters given its shape parameters, so for each
point of a small shape grid the 1- or 2-variable NNLS is solved per texel in
closed form, scored by its χ², and the best point is the start. With
``axis_name`` (a view axis sharded over the ranks of the current mesh,
``parallel/mesh.py``) every view sum is an ``axis_sum`` of the ranks'
partial sums, so each rank starts where the unsharded init would; the JAX
package gets the same from XLA's partitioner.

Both versions live in ``ops/grid_init.py``: :func:`linear_grid_init` runs
the one-launch kernel where the call allows it (:func:`init_path`) and the
eager solves elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import ShadingAngles
from brdf_tpu_torch.ops import grid_init
from brdf_tpu_torch.utils.profiling import span


def default_shape_grid(model: str, num: int = 16) -> np.ndarray:
    """Grid over the model's nonlinear shape parameters, shaped (G, k)."""
    if model in ("phong", "blinn_phong"):
        return np.geomspace(1.0, 300.0, num)[:, None]
    if model == "cook_torrance":
        return np.linspace(0.03, 1.0, num)[:, None]
    if model == "cook_torrance_fresnel":
        r = np.linspace(0.03, 1.0, max(num // 4, 2))
        f = np.linspace(0.05, 1.0, 4)
        rr, ff = np.meshgrid(r, f, indexing="ij")
        return np.stack([rr.ravel(), ff.ravel()], axis=-1)
    if model == "ward":
        return np.linspace(0.05, 1.0, num)[:, None]
    if model == "oren_nayar":
        return np.linspace(0.0, 1.5, num)[:, None]
    if model == "minnaert":
        return np.linspace(0.3, 3.0, num)[:, None]
    if model == "lambert":
        return np.zeros((1, 0))
    if model in ("ward_aniso", "cook_torrance_aniso"):
        r = np.geomspace(0.05, 1.0, max(num // 4, 3))
        rx, ry = np.meshgrid(r, r, indexing="ij")
        out = [
            np.stack([rx.ravel(), ry.ravel(), np.full(rx.size, phi)], axis=-1)
            for phi in (0.0, np.pi / 4)
        ]
        return np.concatenate(out, axis=0)
    raise ValueError(f"no default shape grid for model {model!r}")


def linear_grid_init(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,
    shape_grid: np.ndarray | None = None,
    weights: torch.Tensor | None = None,
    refine: bool = False,
    axis_name: str | None = None,
) -> torch.Tensor:
    """Best (kd, ks, shape…) start per texel from a shape-parameter grid.

    ``refine`` parabolically interpolates the χ²(shape) minimum between the
    best grid point and its neighbours (single-shape lobes), keeping it only
    where it lowers χ². Returns ``(..., n_params)`` clipped to the model box.
    The call is a ``fit.init`` span whose ``path`` says which version ran.
    """
    if shape_grid is None:
        shape_grid = default_shape_grid(model)
    path = init_path(target.device.type, target.dtype, refine, axis_name)
    with span("fit.init", path=path):
        if path == "kernel":
            return grid_init.linear_grid_init_fused(model, angles, target, shape_grid, weights)
        return grid_init.linear_grid_init_plain(model, angles, target, shape_grid, weights,
                                                refine, axis_name)


def init_path(device_type: str, dtype: torch.dtype, refine: bool, axis_name: str | None) -> str:
    """``"kernel"`` (one launch of ``csrc/grid_init.cu``, which refuses a grid
    of more than ``ops/grid_init.py::MAX_GRID`` points) for a float32 target
    on a CUDA device with no view axis and no refine; else ``"eager"``, the
    G eager solves: the CPU's path, a sharded view axis's (its sums cross the
    ranks), the refine's and other dtypes'."""
    if device_type == "cuda" and dtype == torch.float32 and axis_name is None and not refine:
        return "kernel"
    return "eager"
