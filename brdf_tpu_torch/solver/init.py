"""Linearized grid initialization for lobe fits.

Port of ``brdf_tpu/solver/init.py``: every lobe is linear in its leading
``ModelSpec.linear`` parameters given its shape parameters, so for each
point of a small shape grid the 1- or 2-variable NNLS is solved per texel in
closed form, scored by its χ², and the best point is the start. With
``axis_name`` (a view axis sharded over the ranks of the current mesh,
``parallel/mesh.py``) every view sum is an ``axis_sum`` of the ranks'
partial sums, so each rank starts where the unsharded init would; the JAX
package gets the same from XLA's partitioner.
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.parallel.mesh import axis_sum
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


def _nnls2(aa, ab, bb, ay, by):
    """Closed-form 2-variable NNLS ``min ‖x₀A + x₁B − y‖², x ≥ 0`` from
    the Gram entries (interior solution, else the better single-variable one)."""
    det = aa * bb - ab * ab
    det_ok = torch.abs(det) > 1e-30
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    x0 = (bb * ay - ab * by) / det_safe
    x1 = (aa * by - ab * ay) / det_safe
    interior_ok = det_ok & (x0 >= 0) & (x1 >= 0)
    a_only = torch.clamp(ay / torch.clamp(aa, min=1e-30), min=0.0)
    b_only = torch.clamp(by / torch.clamp(bb, min=1e-30), min=0.0)
    cost_a = a_only * a_only * aa - 2.0 * a_only * ay
    cost_b = b_only * b_only * bb - 2.0 * b_only * by
    pick_a = cost_a <= cost_b
    zero = torch.zeros_like(a_only)
    edge0 = torch.where(pick_a, a_only, zero)
    edge1 = torch.where(pick_a, zero, b_only)
    return torch.where(interior_ok, x0, edge0), torch.where(interior_ok, x1, edge1)


def _solve_linear(spec, angles, weights, ty, shape_vals, axis_name=None):
    """Closed-form linear pair at per-texel (or broadcast) shape values
    ``shape_vals`` (..., k) → (params (..., m), cost (...))."""
    def vsum(x):
        return axis_sum(torch.sum(x, -1), axis_name)

    one = shape_vals.new_ones(shape_vals.shape[:-1] + (1,))
    zero = torch.zeros_like(one)
    if spec.linear == 1:
        a = spec.fn(torch.cat([one, shape_vals], -1), angles)
        aa = vsum(a * weights * a)
        ay = vsum(a * ty)
        kd = torch.clamp(ay / torch.clamp(aa, min=1e-30), min=0.0)
        cost = kd * kd * aa - 2.0 * kd * ay
        lin = [kd]
    else:
        a = spec.fn(torch.cat([one, zero, shape_vals], -1), angles)
        b = spec.fn(torch.cat([zero, one, shape_vals], -1), angles)
        aw = a * weights
        bw = b * weights
        aa = vsum(aw * a)
        ab = vsum(aw * b)
        bb = vsum(bw * b)
        ay = vsum(a * ty)
        by = vsum(b * ty)
        kd, ks = _nnls2(aa, ab, bb, ay, by)
        cost = kd * kd * aa + ks * ks * bb + 2 * kd * ks * ab - 2 * (kd * ay + ks * by)
        lin = [kd, ks]
    shape = shape_vals.expand(cost.shape + shape_vals.shape[-1:])
    return torch.cat([x[..., None] for x in lin] + [shape], -1), cost


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
    """
    with span("fit.init"):
        return _linear_grid_init(model, angles, target, shape_grid, weights, refine, axis_name)


def _linear_grid_init(model, angles, target, shape_grid, weights, refine, axis_name):
    spec = MODELS[model]
    n_lin = spec.linear
    k = spec.n_params - n_lin
    if shape_grid is None:
        shape_grid = default_shape_grid(model)
    shape_grid = (
        np.asarray(shape_grid, dtype=np.float64).reshape(-1, k) if k else np.zeros((1, 0))
    )
    dtype = target.dtype
    if weights is None:
        weights = torch.ones_like(target)
    weights = weights.to(dtype)
    ty = target * weights
    grid = torch.as_tensor(shape_grid, dtype=dtype, device=target.device)

    best_p = torch.zeros(target.shape[:-1] + (spec.n_params,), dtype=dtype, device=target.device)
    best_cost = torch.full(target.shape[:-1], float("inf"), dtype=dtype, device=target.device)
    costs = []
    for g in range(grid.shape[0]):
        p_gi, cost = _solve_linear(spec, angles, weights, ty, grid[g], axis_name)
        better = cost < best_cost
        best_p = torch.where(better[..., None], p_gi, best_p)
        best_cost = torch.where(better, cost, best_cost)
        costs.append(cost)

    if refine and k == 1 and shape_grid.shape[0] >= 3:
        best_p, best_cost = _parabolic_refine(
            spec, angles, weights, ty, shape_grid, torch.stack(costs), best_p, best_cost,
            axis_name,
        )
    lo = torch.as_tensor(spec.lower, dtype=dtype, device=target.device)
    hi = torch.as_tensor(spec.upper, dtype=dtype, device=target.device)
    return torch.minimum(torch.maximum(best_p, lo), hi)


def _grid_is_geometric(g1: np.ndarray) -> bool:
    """Interpolate in the coordinate where the grid is uniform: log for a
    geometric grid, linear otherwise."""
    g1 = np.ravel(np.asarray(g1, np.float64))
    if g1.shape[0] < 3 or not bool((g1 > 0).all()):
        return False
    d_lin = np.diff(g1)
    d_log = np.diff(np.log(g1))
    lin_dev = np.ptp(d_lin) / max(np.abs(d_lin).mean(), 1e-300)
    log_dev = np.ptp(d_log) / max(np.abs(d_log).mean(), 1e-300)
    return bool(log_dev < lin_dev)


def _parabolic_refine(spec, angles, weights, ty, shape_grid, costs, best_p, best_cost,
                      axis_name=None):
    """Parabola through the best grid point and its two neighbours, in the
    grid's own coordinate; edge lanes keep their grid value."""
    g1 = np.ravel(np.asarray(shape_grid, np.float64))
    g_count = g1.shape[0]
    use_log = _grid_is_geometric(g1)
    tgv = torch.as_tensor(np.log(g1) if use_log else g1, dtype=costs.dtype, device=costs.device)

    i = torch.argmin(costs, dim=0)
    ic = torch.clamp(i, 1, g_count - 2)
    edge = i != ic
    c0 = torch.gather(costs, 0, ic[None])[0]
    cm = torch.gather(costs, 0, (ic - 1)[None])[0]
    cp = torch.gather(costs, 0, (ic + 1)[None])[0]
    t0, tm, tp = tgv[ic], tgv[ic - 1], tgv[ic + 1]

    denom = cm - 2.0 * c0 + cp
    delta = torch.where(denom > 1e-30, 0.5 * (cm - cp) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    tn = torch.where(delta >= 0, tp, tm)
    t_ref = torch.where(edge, tgv[i], t0 + torch.abs(delta) * (tn - t0))
    shape_ref = torch.exp(t_ref) if use_log else t_ref

    p_ref, cost_ref = _solve_linear(spec, angles, weights, ty, shape_ref[..., None], axis_name)
    better = cost_ref < best_cost
    return (
        torch.where(better[..., None], p_ref, best_p),
        torch.where(better, cost_ref, best_cost),
    )
