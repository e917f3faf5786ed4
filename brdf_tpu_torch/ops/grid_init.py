"""The linear grid init in one launch: the CUDA kernel of
``csrc/grid_init.cu`` and its plain PyTorch version.

Every lobe is linear in its leading ``ModelSpec.linear`` parameters given its
shape parameters, so for each point of a small shape grid the 1- or
2-variable NNLS is solved per texel in closed form, scored by its Gram-form
cost, and the first point of least cost is the start, clipped to the model's
box. :func:`linear_grid_init_plain` is that algorithm as G eager solves (two
lobe evaluations, five view sums and some 25 elementwise operations of
:func:`_nnls2` a grid point: 100–150 launches a point on a card). It is what
the CPU runs, and on a card what a call with a sharded view axis or the
parabolic refine runs. :func:`linear_grid_init_fused` runs the same
algorithm as one launch of ``grid_init_kernel`` (:func:`grid_init_cuda`,
counted in :data:`LAUNCHES`).

The kernel solves a texel with a group of S lanes of one warp, lane l holding
views l, l + S, … in registers (``csrc/lanegroup.cuh``; :func:`kernel_layout`
picks S from the angle channels and V; past :func:`max_views` 32 lanes that
read their views from device memory at every grid point). It reads a texel's
angles, y and w once and runs every grid point from registers: two
evaluations of K0's lobe a (view, point), the view sums as a lane's partial
then an XOR butterfly, and the scalar solve replicated on the group's lanes.
So its view sums are in another order than ``torch.sum``'s: the two versions
agree to float32's rounding of a 16-term sum, and pick another grid point
only where two points' costs tie within it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.ops import _build
from brdf_tpu_torch.ops.lanegroup import group_lanes, long_view_layout
from brdf_tpu_torch.ops.shading import SHADING_KERNELS
from brdf_tpu_torch.parallel.mesh import axis_sum

# the kernel's block: four warps (csrc/grid_init.cu kThreads)
THREADS = 128
# grid points a launch takes (csrc/grid_init.cu kMaxGrid): the grid goes in
# by value as a kernel parameter
MAX_GRID = 64
# The view state a lane may hold, in floats: the angles, w and y·w of each of
# its views (csrc/grid_init.cu kLaneStateFloats). Past 32 lanes of that the
# kernel reads its views from device memory at every grid point.
LANE_STATE_FLOATS = 32
# Kernel launches made by grid_init_cuda since the count was last reset.
LAUNCHES = 0


# ---------------------------------------------------------------------------
# The plain version: G eager solves
# ---------------------------------------------------------------------------


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


def linear_grid_init_plain(model, angles, target, shape_grid, weights=None, refine=False,
                           axis_name=None):
    """The grid init as G eager solves, on any device and dtype: the
    arguments of ``solver/init.py::linear_grid_init`` with the grid given."""
    spec = MODELS[model]
    n_lin = spec.linear
    k = spec.n_params - n_lin
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


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def max_views(n_angles: int) -> int:
    """The most views the kernel holds in registers: 32 lanes of
    ``LANE_STATE_FLOATS`` floats, ``n_angles + 2`` floats a view."""
    return 32 * (LANE_STATE_FLOATS // (n_angles + 2))


def kernel_layout(n_angles: int, v: int) -> tuple[int, int, int]:
    """``(S, VPL, block_t)``: the fewest lanes S a texel (a power of two up to
    32) that hold its ``v`` views in registers, VPL = ⌈v / S⌉ of them a lane
    (at V=16: S = 2 for the one- and two-channel lobes, 4 for three to five
    channels, 8 for cook_torrance_aniso's nine), ``THREADS // S`` texels a
    block; past :func:`max_views` the long-view layout, whose 32 lanes read
    their views from device memory at every grid point."""
    if v > max_views(n_angles):
        return long_view_layout(v, THREADS)
    lanes = group_lanes(v, LANE_STATE_FLOATS // (n_angles + 2))
    return lanes, -(-v // lanes), THREADS // lanes


_P, _I = _build.P, _build.I
_GRID_INIT = _build.Entry("the grid init kernel", "grid_init", "brdf_grid_init",
                          (_I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P))
_OCCUPANCY = _build.Entry("the grid init kernel", "grid_init", "brdf_grid_init_occupancy",
                          (_I, _I, _I, _P))


def occupancy(model: str, v: int) -> dict:
    """What the instantiation for ``model`` at ``v`` views gets on the current
    card: its layout, resident blocks and warps an SM, registers and
    local-memory bytes a thread (the CUDA runtime's own figures)."""
    spec = SHADING_KERNELS[model]
    lanes, vpl, block_t = kernel_layout(len(spec.angle_names), v)
    res = _build.query(_OCCUPANCY, 4, spec.lobe_id, v, lanes)
    return dict(lanes=lanes, views_per_lane=vpl, block_t=block_t, blocks_per_sm=res[0],
                warps_per_sm=res[0] * res[3] // 32, registers=res[1], local_bytes=res[2])


def grid_init_cuda(model: str, ang, y, w, grid) -> torch.Tensor:
    """Launch the kernel on texel-major inputs: ``ang (A, T, V)`` the lobe's
    angle channels in ``SHADING_KERNELS[model].angle_names`` order, ``y (T,
    V)``, ``w (T, V)`` or ``None`` for unit weights, all contiguous float32
    on one CUDA device, and ``grid (G, k)`` the shape points (host values,
    rounded to float32) → the ``(T, n_params)`` starts, clipped to the box."""
    global LAUNCHES
    if model not in SHADING_KERNELS:
        raise ValueError(f"the grid init kernel has no lobe {model!r}")
    spec = MODELS[model]
    n_angles = len(SHADING_KERNELS[model].angle_names)
    k = spec.n_params - spec.linear
    grid = np.asarray(grid, dtype=np.float32)
    if grid.ndim != 2 or grid.shape[1] != k or not 1 <= grid.shape[0] <= MAX_GRID:
        raise ValueError(f"the grid init kernel takes 1 to {MAX_GRID} grid points of {k} "
                         f"shape values for {model}, got a grid of shape {grid.shape}")
    if ang.ndim != 3 or ang.shape[0] != n_angles or y.shape != ang.shape[1:] or (
            w is not None and w.shape != y.shape):
        raise ValueError(f"grid init shapes: {model} reads ang ({n_angles}, T, V), y and w (T, V); "
                         f"got ang {tuple(ang.shape)}, y {tuple(y.shape)}, "
                         f"w {None if w is None else tuple(w.shape)}")
    _build.check_operands("the grid init kernel", ang, y, *(() if w is None else (w,)))
    _, t, v = ang.shape
    if t >= 2**31 or v >= 2**31 - 32:
        raise ValueError(f"the grid init kernel indexes texels and views with 32-bit ints; "
                         f"T={t}, V={v} is too large")
    out = torch.empty((t, spec.n_params), dtype=torch.float32, device=ang.device)
    if t == 0:
        return out
    lanes, _, _ = kernel_layout(n_angles, v)
    flat = (ctypes.c_float * grid.size)(*grid.ravel().tolist())
    lo = (ctypes.c_float * spec.n_params)(*spec.lower)
    hi = (ctypes.c_float * spec.n_params)(*spec.upper)
    _build.launch(_GRID_INIT, ang.device, SHADING_KERNELS[model].lobe_id, ang.data_ptr(),
                  y.data_ptr(), None if w is None else w.data_ptr(), out.data_ptr(), t, v, lanes,
                  flat, grid.shape[0], k, lo, hi)
    LAUNCHES += 1
    return out


def stack_inputs(model: str, angles: ShadingAngles, target, weights=None):
    """Public ``(..., V)`` inputs, broadcast against each other → ``ang (A, T,
    V)``, ``y (T, V)`` and ``w (T, V)`` (or None) as contiguous float32, and
    the leading shape ``(...)`` that T flattens."""
    names = SHADING_KERNELS[model].angle_names
    chans = [getattr(angles, n) for n in names]
    missing = [n for n, c in zip(names, chans) if c is None]
    if missing:
        raise ValueError(f"{model} reads the angle channels {missing}, which are not filled "
                         "(build the angles with tangent_frame=True)")
    # numpy's, not torch.broadcast_shapes: that imports sympy, seconds at first use
    shape = np.broadcast_shapes(target.shape, *(c.shape for c in chans),
                                *(() if weights is None else (weights.shape,)))
    f32 = torch.float32

    def flat(x):
        return x.to(f32).expand(shape).reshape(-1, shape[-1]).contiguous()

    ang = torch.stack([c.to(f32).expand(shape).reshape(-1, shape[-1]) for c in chans])
    return ang, flat(target), None if weights is None else flat(weights), tuple(shape[:-1])


def linear_grid_init_fused(model, angles, target, shape_grid, weights=None) -> torch.Tensor:
    """The grid init as one launch of the kernel on CUDA inputs: the
    arguments of ``solver/init.py::linear_grid_init`` with the grid given
    and no refine or view axis → ``(..., n_params)``."""
    spec = MODELS[model]
    k = spec.n_params - spec.linear
    grid = np.asarray(shape_grid, dtype=np.float64).reshape(-1, k) if k else np.zeros((1, 0))
    ang, y, w, lead = stack_inputs(model, angles, target, weights)
    return grid_init_cuda(model, ang, y, w, grid).reshape(lead + (spec.n_params,))
