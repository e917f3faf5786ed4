"""Fused d-D VarPro solve for the m=4 and m=5 separable lobes: CUDA kernel K8
and its plain PyTorch version.

The kernel (``csrc/varpro_nd.cu``) replaces
``brdf_tpu/ops/varpro_pallas.py::_varpro_nd_kernel``; the plain version below
mirrors ``varpro_fit_pallas_nd`` operation for operation: a grid of shape
d-tuples (``default_shape_grid`` clipped to the floored shape box) with the
closed-form :func:`~brdf_tpu_torch.solver.varpro._bvls2` at each point, then
``iters`` Kaufman-projected d×d Newton steps (the damped closed-form solve
:func:`~brdf_tpu_torch.solver.varpro._solve_damped_sym`, the step clipped to
a trust radius and to the box, accepted if χ² falls); a caller ``p0`` skips
the grid and starts from its shape columns. One lobe evaluation per step
gives b and every ∂b/∂shape_j. It does not mirror the eager
``solver/varpro.py::varpro_fit_nd``, whose default init is
``linear_grid_init`` and which evaluates ∂b/∂shape_j by JVPs.

The lobes: ``cook_torrance_fresnel`` (d=2, its ``engine="varpro"`` path is
the eager ``varpro_fit_fresnel_lin``), ``ward_aniso`` and
``cook_torrance_aniso`` (d=3).

:func:`varpro_fit_fused_nd` takes the public texel-major ``(T, V)`` layout
and transposes once to the views-major ``(V, T)`` layout both versions run
on. For CUDA tensors it launches K8 (and counts the launch in
:data:`LAUNCHES`); for CPU tensors it runs the plain version. It never falls
back from one to the other.

K8 solves a texel with a group of S lanes, each holding VPL of its views
(:func:`lane_layout`; past :func:`max_views` 32 lanes that read their views
from device memory in every pass, :func:`kernel_layout`), and sums over views
in that layout's fixed order
(``ops/lanegroup.py::group_sum``): each lane's views left to right, then a pairwise tree
over the lanes. The plain version sums in the same order, so the two agree
bit for bit on the card; the Pallas kernel's ``jnp.sum`` order is XLA's, and
the tests hold the plain version to it at the solve's float32 chaos.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.ops import _build
from brdf_tpu_torch.ops.lanegroup import group_lanes, group_sum, long_view_layout
from brdf_tpu_torch.ops.shading import SHADING_KERNELS
from brdf_tpu_torch.solver.init import default_shape_grid
from brdf_tpu_torch.solver.varpro import (
    _SEPARABLE_ND,
    VarProResult,
    _bvls2,
    _solve_damped_sym,
    shape_box,
)
from brdf_tpu_torch.utils import profiling
from brdf_tpu_torch.utils.profiling import span

_TINY = 1e-30
# the kernel's limit on grid d-tuples (csrc/varpro_nd.cu kMaxGrid):
# grid_points=16 gives 32 for the anisotropic lobes
MAX_GRID = 32
# K8's block: four warps (csrc/varpro_nd.cu kThreads)
THREADS = 128
# The view state a lane may hold, in floats: angles, w, y·w, a·w, b·w and the
# d ∂b/∂shape_j of each of its views (csrc/varpro_nd.cu kLaneStateFloats).
# Past 32 lanes of that the kernel runs its long-view path, which reads the
# views from device memory in every pass.
LANE_STATE_FLOATS = 64
# Views a lane holds while a group of up to 32 lanes can take the views:
# fewer mean more lanes a texel, and so more copies of the scalar solve; more
# mean more registers a thread and fewer warps an SM. Chosen on an H100 at
# V=16 from (S, VPL) = (4, 4), (8, 2) and (16, 1) (PERF.md, the K8 findings).
VIEWS_PER_LANE = 2
# Kernel launches made by varpro_nd_rows_cuda since the count was last reset.
LAUNCHES = 0


class VarProNDConfig(NamedTuple):
    """Everything static about one solve; the same values reach both versions."""

    model: str
    d: int
    grid: tuple[tuple[float, ...], ...]   # shape d-tuples, float32 values
    box: tuple[float, float, float, float]   # l0, u0, l1, u1 of (kd, ks)
    lo_s: tuple[float, ...]               # the floored d-D shape box
    hi_s: tuple[float, ...]
    span: float                           # ‖hi_s − lo_s‖


def config(model: str, lower=None, upper=None, grid_points: int = 8) -> VarProNDConfig:
    if model not in _SEPARABLE_ND or model not in SHADING_KERNELS:
        raise ValueError(
            f"the fused d-D VarPro solve supports {sorted(_SEPARABLE_ND)} kernel lobes, got {model!r}")
    mspec = MODELS[model]
    d = mspec.n_params - 2
    lo = tuple(float(x) for x in (mspec.lower if lower is None else lower))
    hi = tuple(float(x) for x in (mspec.upper if upper is None else upper))
    lo_s, hi_s = shape_box(model, lo, hi)
    grid_np = np.asarray(default_shape_grid(model, num=grid_points), np.float64).reshape(-1, d)
    grid_np = np.clip(grid_np, np.asarray(lo_s), np.asarray(hi_s))
    if len(grid_np) > MAX_GRID:
        raise ValueError(
            f"the fused d-D VarPro solve takes at most {MAX_GRID} grid points, got {len(grid_np)}")
    return VarProNDConfig(
        model=model, d=d,
        grid=tuple(tuple(float(np.float32(x)) for x in row) for row in grid_np),
        box=(lo[0], hi[0], lo[1], hi[1]), lo_s=lo_s, hi_s=hi_s,
        span=float(np.sqrt(sum((h - l) ** 2 for h, l in zip(hi_s, lo_s)))),
    )


def stack_inputs(model: str, angles: ShadingAngles, target, weights=None, p0=None):
    """Public ``(T, V)`` inputs → ``ang (A, V, T)``, ``y``/``w (V, T)`` and the
    caller's start as ``(m, T)`` rows (or None), all contiguous float32."""
    names = SHADING_KERNELS[model].angle_names
    f32 = torch.float32
    ang = torch.stack([getattr(angles, n).to(f32).T for n in names]).contiguous()
    y = target.to(f32).T.contiguous()
    w = torch.ones_like(y) if weights is None else weights.to(f32).T.contiguous()
    p0_rows = None if p0 is None else p0.to(f32).T.contiguous()
    return ang, y, w, p0_rows


def varpro_nd_rows_plain(cfg: VarProNDConfig, ang, y, w, p0_rows, iters: int) -> torch.Tensor:
    """K8's plain version on ``(V, T)`` inputs → the ``(16, T)`` output rows
    (kd, ks, shape[0..d), χ², accepted steps, stop, max_j |g_j|, zeros)."""
    spec = SHADING_KERNELS[cfg.model]
    d = cfg.d
    angles = tuple(ang[a] for a in range(ang.shape[0]))
    yw = y * w
    one = torch.ones_like(y[:1])
    zero = torch.zeros_like(one)
    l0, u0, l1, u1 = cfg.box
    span = cfg.span
    lanes, vpl, _ = kernel_layout(ang.shape[0], d, ang.shape[1])

    def rsum(x):
        return group_sum(x, lanes, vpl)

    def eval_shape(rows):
        """One lobe evaluation → (a, b, (∂b/∂shape_j)_j), each (V, T)."""
        i_val, d_params, _ = spec.eval(angles, (zero, one) + tuple(rows))
        return d_params[0], i_val, tuple(d_params[2 + j] for j in range(d))

    a, _, _ = eval_shape([zero + g for g in cfg.grid[0]])
    aw = a * w
    aa = rsum(aw * aw)
    ay = rsum(aw * yw)

    if p0_rows is not None:
        shape = [torch.clamp(p0_rows[2 + j:3 + j], cfg.lo_s[j], cfg.hi_s[j]) for j in range(d)]
    else:
        # grid init: the Gram-form cost only ranks the points
        shape = [zero + cfg.grid[0][j] for j in range(d)]
        best_cost = torch.full_like(zero, float("inf"))
        for gval in cfg.grid:
            rows = [zero + gval[j] for j in range(d)]
            _, b, _ = eval_shape(rows)
            bw = b * w
            ab, bb, by = rsum(aw * bw), rsum(bw * bw), rsum(bw * yw)
            kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
            cost = kd * kd * aa + ks * ks * bb + 2.0 * kd * ks * ab - 2.0 * (kd * ay + ks * by)
            better = cost < best_cost
            shape = [torch.where(better, r, s) for r, s in zip(rows, shape)]
            best_cost = torch.where(better, cost, best_cost)

    def eval_at(rows):
        """Profiled χ², gradient (d), Kaufman-projected Gauss-Newton H (upper
        triangle), kd, ks."""
        _, b, dbs = eval_shape(rows)
        bw = b * w
        ab, bb, by = rsum(aw * bw), rsum(bw * bw), rsum(bw * yw)
        kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
        rw = yw - kd * aw - ks * bw
        chi2 = rsum(rw * rw)
        det = aa * bb - ab * ab
        det_ok = det > _TINY
        det_s = torch.where(det_ok, det, torch.ones_like(det))
        g_rows, cols = [], []
        for j in range(d):
            u = ks * dbs[j] * w
            g_rows.append(-2.0 * rsum(rw * u))
            ua = rsum(u * aw)
            ub = rsum(u * bw)
            x1 = torch.where(det_ok, (bb * ua - ab * ub) / det_s, zero)
            x2 = torch.where(det_ok, (aa * ub - ab * ua) / det_s, zero)
            cols.append(u - x1 * aw - x2 * bw)
        h = {(j, k): 2.0 * rsum(cols[j] * cols[k]) for j in range(d) for k in range(j, d)}
        return chi2, g_rows, h, kd, ks

    chi2, g, h, kd, ks = eval_at(shape)
    trust = zero + 0.25 * span
    n_acc = torch.zeros_like(zero)
    for _ in range(iters):
        lam = 1e-6 * sum(h[(j, j)] for j in range(d)) + _TINY
        steps, ok_h = _solve_damped_sym(h, g, d, lam)
        nrm2 = sum(st * st for st in steps)
        nrm = torch.sqrt(torch.clamp(nrm2, min=_TINY))
        scale = torch.where(ok_h, torch.clamp(trust / nrm, max=1.0), zero)
        shape_n = [torch.clamp(shape[j] + steps[j] * scale, cfg.lo_s[j], cfg.hi_s[j])
                   for j in range(d)]
        chi2_n, g_n, h_n, kd_n, ks_n = eval_at(shape_n)
        ok = (chi2_n < chi2) & torch.isfinite(chi2_n)
        shape = [torch.where(ok, shape_n[j], shape[j]) for j in range(d)]
        chi2 = torch.where(ok, chi2_n, chi2)
        g = [torch.where(ok, g_n[j], g[j]) for j in range(d)]
        h = {k: torch.where(ok, h_n[k], h[k]) for k in h}
        kd = torch.where(ok, kd_n, kd)
        ks = torch.where(ok, ks_n, ks)
        trust = torch.where(ok, torch.clamp(trust * 2.0, max=span), trust * 0.25)
        n_acc = n_acc + ok.to(n_acc.dtype)

    stop = torch.where(trust < 1e-6 * span, 2.0, 3.0).to(zero.dtype)
    g_abs = torch.abs(g[0])
    for j in range(1, d):
        g_abs = torch.maximum(g_abs, torch.abs(g[j]))
    rows = [kd, ks, *shape, torch.clamp(chi2, min=0.0), n_acc, stop, g_abs]
    return torch.cat(rows + [zero] * (16 - len(rows)))


def max_views(n_angles: int, d: int) -> int:
    """The most views K8 holds in registers: 32 lanes a texel, each within
    ``LANE_STATE_FLOATS`` of view state (``n_angles + 4 + d`` floats a view)."""
    return 32 * (LANE_STATE_FLOATS // (n_angles + 4 + d))


def lane_layout(n_angles: int, d: int, v: int) -> tuple[int, int, int]:
    """K8's layout for ``v`` views → ``(S, VPL, block_t)``: S lanes a texel
    (a power of two that divides 32), VPL = ⌈v / S⌉ views a lane (lane l holds
    views l, l + S, …), ``block_t`` = 128 / S texels a block. S is the
    smallest that gives a lane at most ``VIEWS_PER_LANE`` views, or 32; past
    :func:`max_views` the views do not fit registers and it raises (K8 runs
    them on its long-view path, :func:`kernel_layout`)."""
    if not 1 <= v <= max_views(n_angles, d):
        raise ValueError(
            f"V={v} views do not fit the fused d-D VarPro kernel's registers "
            f"(1 to {max_views(n_angles, d)} views for {n_angles + 4 + d} floats a view)")
    lanes = group_lanes(v, VIEWS_PER_LANE)
    return lanes, -(-v // lanes), THREADS // lanes


def kernel_layout(n_angles: int, d: int, v: int) -> tuple[int, int, int]:
    """The layout K8 runs ``v`` views in, for the wrapper and the plain
    version alike: :func:`lane_layout` (views in registers) up to
    :func:`max_views`, the long-view path's
    :func:`~brdf_tpu_torch.ops.lanegroup.long_view_layout` past it."""
    if v > max_views(n_angles, d):
        return long_view_layout(v, THREADS)
    return lane_layout(n_angles, d, v)


_P, _I, _F = _build.P, _build.I, _build.F
_FIT = _build.Entry("K8", "varpro_nd", "brdf_varpro_nd_fit", (
    _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _F, _F, _F, _F, _P, _P, _F, _F, _F, _I,
    _P))
_OCCUPANCY = _build.Entry("K8", "varpro_nd", "brdf_varpro_nd_occupancy", (_I, _I, _I, _I, _P))


def occupancy(model: str, v: int) -> dict:
    """What K8's instantiation for ``model`` at ``v`` views gets on the
    current card: its layout, resident blocks and warps an SM, registers and
    local-memory bytes a thread (the CUDA runtime's own figures)."""
    spec = SHADING_KERNELS[model]
    d = spec.n_params - 2
    lanes, vpl, block_t = kernel_layout(len(spec.angle_names), d, v)
    res = _build.query(_OCCUPANCY, 4, spec.lobe_id, d, vpl, lanes)
    return dict(lanes=lanes, views_per_lane=vpl, block_t=block_t, blocks_per_sm=res[0],
                warps_per_sm=res[0] * res[3] // 32, registers=res[1], local_bytes=res[2])


def varpro_nd_rows_cuda(cfg: VarProNDConfig, ang, y, w, p0_rows, iters: int) -> torch.Tensor:
    """Launch K8 on ``(V, T)`` CUDA inputs → the ``(16, T)`` output rows."""
    global LAUNCHES
    a_count, v, t = ang.shape
    _build.check_operands("K8", ang, y, w, *(() if p0_rows is None else (p0_rows,)))
    spec = SHADING_KERNELS[cfg.model]
    if a_count != len(spec.angle_names) or y.shape != (v, t) or w.shape != (v, t):
        raise ValueError(f"K8 shapes: ang {tuple(ang.shape)}, y {tuple(y.shape)}, w {tuple(w.shape)}")
    if p0_rows is not None and p0_rows.shape != (spec.n_params, t):
        raise ValueError(f"K8 takes a ({spec.n_params}, T) start, got {tuple(p0_rows.shape)}")
    if t >= 2**31 // 16 or v > 2**31 - 32:
        raise ValueError(f"K8 indexes texels and views with 32-bit ints; "
                         f"T={t}, V={v} is too large")
    lanes, vpl, _ = kernel_layout(a_count, cfg.d, v)
    out = torch.empty((16, t), dtype=torch.float32, device=ang.device)
    if t == 0:
        return out
    n = len(cfg.grid)
    grid = (ctypes.c_float * (n * cfg.d))(*(x for row in cfg.grid for x in row))
    lo_s = (ctypes.c_float * cfg.d)(*cfg.lo_s)
    hi_s = (ctypes.c_float * cfg.d)(*cfg.hi_s)
    _build.launch(
        _FIT, ang.device, spec.lobe_id, ang.data_ptr(), y.data_ptr(), w.data_ptr(),
        None if p0_rows is None else p0_rows.data_ptr(), out.data_ptr(),
        t, v, lanes, vpl, grid, n, cfg.d, *cfg.box, lo_s, hi_s,
        cfg.span, 0.25 * cfg.span, 1e-6 * cfg.span, int(iters),
    )
    LAUNCHES += 1
    return out


def rows_to_result(out: torch.Tensor, d: int) -> VarProResult:
    return VarProResult(
        p=out[:2 + d].T.contiguous(),
        chi2=out[2 + d],
        iters=out[3 + d].to(torch.int32),
        stop=out[4 + d].to(torch.int32),
        g_abs=out[5 + d],
    )


def varpro_fit_fused_nd(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,              # (T, V)
    weights: torch.Tensor | None = None,
    p0: torch.Tensor | None = None,    # (T, m) optional start (else grid init)
    iters: int = 12,
    lower: tuple | None = None,
    upper: tuple | None = None,
    grid_points: int = 8,
) -> VarProResult:
    """The fused d-D VarPro solve: K8 for CUDA tensors, its plain version for
    CPU tensors. Same public contract as ``varpro_fit_pallas_nd``.

    With recording on (``utils/profiling.py``) the call is a ``varpro_nd``
    span (model, lanes, views, grid tuples, iterations, whether a start was
    given, angle channels staged) around the layout work and the launch, and
    the counters ``varpro_nd.steps`` and ``varpro_nd.accepted`` add the
    lanes × iterations of the fixed schedule and the accepted Newton steps
    summed over the lanes (one read of the device)."""
    cfg = config(model, lower, upper, grid_points)
    t, v = target.shape
    with span("varpro_nd", model=model, lanes=t, views=v, grid=len(cfg.grid), iters=int(iters),
              with_p0=p0 is not None, angles=len(SHADING_KERNELS[model].angle_names)):
        ang, y, w, p0_rows = stack_inputs(model, angles, target, weights, p0)
        rows = (varpro_nd_rows_cuda if _build.on_cuda(target, "the fused d-D VarPro solve runs")
                else varpro_nd_rows_plain)
        out = rows(cfg, ang, y, w, p0_rows, iters)
    if profiling.enabled():
        profiling.count("varpro_nd.steps", t * int(iters))
        profiling.count("varpro_nd.accepted", int(out[3 + cfg.d].sum(dtype=torch.float64)))
    return rows_to_result(out, cfg.d)
