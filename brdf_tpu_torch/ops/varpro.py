"""Fused VarPro solve for the separable lobes: CUDA kernel K1 and its plain
PyTorch version.

The kernel (``csrc/varpro.cu``) replaces
``brdf_tpu/ops/varpro_pallas.py::_varpro_kernel``; the plain version below
mirrors ``varpro_fit_pallas`` operation for operation: the box-filtered
shape grid (8 points by default, no parabolic refine) with the closed-form
:func:`~brdf_tpu_torch.solver.varpro._bvls2` at each point, then ``iters``
profiled Newton steps with Kaufman's projected curvature and a
trust-clipped accept-if-better step; a caller ``p0`` skips the grid and
starts from its σ (row 2). It does not mirror ``solver/varpro.py::varpro_fit``,
whose default init is the refined 16-point grid.

:func:`varpro_fit_fused` takes the public texel-major ``(T, V)`` layout and
transposes once to the views-major ``(V, T)`` layout both versions run on.
For CUDA tensors it launches K1 (and counts the launch in
:data:`LAUNCHES`); for CPU tensors it runs the plain version. It never
falls back from one to the other.

On the card K1 is bound by FP32 and special-function issue, not by bytes:
each texel reads its inputs once and evaluates its lobe
``(grid + 1 + iters)`` times per view (see the note in ``csrc/varpro.cu``).

K1 solves a texel with a group of S lanes, each holding VPL of its views
(:func:`lane_layout`; past :func:`max_views` 32 lanes that read their views
from device memory in every pass, :func:`kernel_layout`), and sums over views
in that layout's fixed order
(``ops/lanegroup.py::group_sum``): each lane's views left to right, then a
pairwise tree over the lanes. The plain version sums in the same order, so
the two agree bit for bit on the card; the Pallas kernel's ``jnp.sum``
order is XLA's, and the tests hold the plain version to it at the solve's
float32 chaos.
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
from brdf_tpu_torch.solver.varpro import _SEPARABLE, VarProResult, _bvls2, sigma_domain

_TINY = 1e-30
# K1's block: four warps (csrc/varpro.cu kThreads)
THREADS = 128
# The view state a lane may hold, in floats: what a view gives alone (as
# many floats as its angles), w, y·w, a·w, b·w and ∂b·w of each of its views
# (csrc/varpro.cu kLaneStateFloats). Past 32 lanes of that the kernel runs
# its long-view path, which reads the views from device memory in every pass.
LANE_STATE_FLOATS = 64
# Views a lane holds while a group of up to 32 lanes can take the views, by
# angle channels: fewer mean more lanes a texel, and so more copies of the
# scalar solve; more mean more registers a thread and fewer warps an SM.
# Chosen on an H100 at V=16 from S = 2, 4, 8 and 16 lanes a texel, among the
# layouts the CPU bars take (PERF.md, the K1 findings; ROADMAP Queue C). Its
# twin is csrc/varpro.cu's kViewsPerLane, which gives these instantiations
# 20 warps an SM; the two must agree.
VIEWS_PER_LANE_BY_ANGLES = {2: 8, 3: 4}
# Kernel launches made by varpro_rows_cuda since the count was last reset.
LAUNCHES = 0


class VarProConfig(NamedTuple):
    """Everything static about one solve; the same values reach both versions."""

    model: str
    grid_sig: tuple[float, ...]   # grid σ values
    grid_t: tuple[float, ...]     # the same points in the Newton coordinate
    box: tuple[float, float, float, float]   # l0, u0, l1, u1 of (kd, ks)
    use_log: bool
    s_lo: float
    s_hi: float
    p0_lo: float                  # clip of a caller's σ start
    p0_hi: float


def config(model: str, lower=None, upper=None, grid_points: int = 8) -> VarProConfig:
    if model not in _SEPARABLE or model not in SHADING_KERNELS:
        raise ValueError(f"the fused VarPro solve supports separable kernel lobes, got {model!r}")
    mspec = MODELS[model]
    lo = tuple(float(x) for x in (mspec.lower if lower is None else lower))
    hi = tuple(float(x) for x in (mspec.upper if upper is None else upper))
    use_log, sig_floor, s_lo, s_hi = sigma_domain(model, lo, hi)
    grid = tuple(
        float(x) for x in np.ravel(default_shape_grid(model, num=grid_points))
        if sig_floor <= float(x) <= hi[2]
    ) or (sig_floor,)
    if len(grid) > 16:
        raise ValueError(f"the fused VarPro solve takes at most 16 grid points, got {len(grid)}")
    return VarProConfig(
        model=model,
        grid_sig=tuple(float(np.float32(g)) for g in grid),
        grid_t=tuple(float(np.float32(np.log(g) if use_log else g)) for g in grid),
        box=(lo[0], hi[0], lo[1], hi[1]),
        use_log=use_log, s_lo=s_lo, s_hi=s_hi,
        p0_lo=float(np.exp(s_lo)) if use_log else s_lo,
        p0_hi=float(np.exp(s_hi)) if use_log else s_hi,
    )


def stack_inputs(model: str, angles: ShadingAngles, target, weights=None, p0=None):
    """Public ``(T, V)`` inputs → ``ang (A, V, T)``, ``y``/``w (V, T)`` and the
    caller's σ start ``(T,)`` (or None), all contiguous float32."""
    names = SHADING_KERNELS[model].angle_names
    f32 = torch.float32
    ang = torch.stack([getattr(angles, n).to(f32).T for n in names]).contiguous()
    y = target.to(f32).T.contiguous()
    w = torch.ones_like(y) if weights is None else weights.to(f32).T.contiguous()
    sig0 = None if p0 is None else p0[:, 2].to(f32).contiguous()
    return ang, y, w, sig0


def varpro_rows_plain(cfg: VarProConfig, ang, y, w, sig0, iters: int) -> torch.Tensor:
    """K1's plain version on ``(V, T)`` inputs → the ``(8, T)`` output rows
    (kd, ks, σ, χ², accepted steps, stop, |g|, 0)."""
    spec = SHADING_KERNELS[cfg.model]
    angles = tuple(ang[a] for a in range(ang.shape[0]))
    yw = y * w
    one = torch.ones_like(y[:1])
    zero = torch.zeros_like(one)
    l0, u0, l1, u1 = cfg.box
    lanes, vpl, _ = kernel_layout(ang.shape[0], ang.shape[1])

    def rsum(x):
        return group_sum(x, lanes, vpl)

    def eval_sig(sig_row):
        i_val, d_params, _ = spec.eval(angles, (zero, one, sig_row))
        return d_params[0], i_val, d_params[2]

    a, _, _ = eval_sig(zero + cfg.grid_sig[0])
    aw = a * w
    aa = rsum(aw * aw)
    ay = rsum(aw * yw)

    if sig0 is not None:
        s0 = torch.clamp(sig0[None], cfg.p0_lo, cfg.p0_hi)
        best_t = torch.log(s0) if cfg.use_log else s0
    else:
        best_t = zero + cfg.grid_t[0]
        best_cost = torch.full_like(zero, float("inf"))
        for sig_g, t_g in zip(cfg.grid_sig, cfg.grid_t):
            _, b, _ = eval_sig(zero + sig_g)
            bw = b * w
            ab, bb, by = rsum(aw * bw), rsum(bw * bw), rsum(bw * yw)
            kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
            cost = kd * kd * aa + ks * ks * bb + 2.0 * kd * ks * ab - 2.0 * (kd * ay + ks * by)
            better = cost < best_cost
            best_t = torch.where(better, zero + t_g, best_t)
            best_cost = torch.where(better, cost, best_cost)

    def eval_at(t_row):
        sig = torch.exp(t_row) if cfg.use_log else t_row
        _, b, db = eval_sig(sig)
        db_t = db * sig if cfg.use_log else db
        bw = b * w
        dbw = db_t * w
        ab, bb, by = rsum(aw * bw), rsum(bw * bw), rsum(bw * yw)
        kd, ks = _bvls2(aa, ab, bb, ay, by, l0, u0, l1, u1)
        rw = yw - kd * aw - ks * bw
        chi2 = rsum(rw * rw)
        g = -2.0 * ks * rsum(rw * dbw)
        a_db = rsum(aw * dbw)
        b_db = rsum(bw * dbw)
        det = aa * bb - ab * ab
        det_ok = det > _TINY
        det_s = torch.where(det_ok, det, torch.ones_like(det))
        x1 = torch.where(det_ok, (bb * a_db - ab * b_db) / det_s, zero)
        x2 = torch.where(det_ok, (aa * b_db - ab * a_db) / det_s, zero)
        proj = rsum(dbw * dbw) - x1 * a_db - x2 * b_db
        h = 2.0 * ks * ks * torch.clamp(proj, min=0.0)
        return chi2, g, h, kd, ks

    span = float(cfg.s_hi - cfg.s_lo)
    t_c = best_t
    chi2, g, h, kd, ks = eval_at(t_c)
    trust = zero + 0.25 * span
    n_acc = torch.zeros_like(zero)
    for _ in range(iters):
        step = torch.clamp(-g / torch.clamp(h, min=_TINY), -trust, trust)
        t_new = torch.clamp(t_c + step, cfg.s_lo, cfg.s_hi)
        chi2_n, g_n, h_n, kd_n, ks_n = eval_at(t_new)
        ok = (chi2_n < chi2) & torch.isfinite(chi2_n)
        t_c = torch.where(ok, t_new, t_c)
        chi2 = torch.where(ok, chi2_n, chi2)
        g = torch.where(ok, g_n, g)
        h = torch.where(ok, h_n, h)
        kd = torch.where(ok, kd_n, kd)
        ks = torch.where(ok, ks_n, ks)
        trust = torch.where(ok, torch.clamp(trust * 2.0, max=span), trust * 0.25)
        n_acc = n_acc + ok.to(n_acc.dtype)

    sigma = torch.exp(t_c) if cfg.use_log else t_c
    stop = torch.where(trust < 1e-6 * span, 2.0, 3.0).to(zero.dtype)
    return torch.cat([
        kd, ks, sigma, torch.clamp(chi2, min=0.0), n_acc, stop, torch.abs(g), zero,
    ])


def max_views(n_angles: int) -> int:
    """The most views K1 holds in registers: 32 lanes a texel, each within
    ``LANE_STATE_FLOATS`` of view state (``n_angles + 5`` floats a view)."""
    return 32 * (LANE_STATE_FLOATS // (n_angles + 5))


def lane_layout(n_angles: int, v: int) -> tuple[int, int, int]:
    """K1's layout for ``v`` views of ``n_angles`` channels → ``(S, VPL,
    block_t)``: S lanes a texel (a power of two that divides 32), VPL = ⌈v / S⌉
    views a lane (lane l holds views l, l + S, …), ``block_t`` = 128 / S
    texels a block. S is the smallest that gives a lane at most
    ``VIEWS_PER_LANE_BY_ANGLES[n_angles]`` views, or 32; past
    :func:`max_views` the views do not fit registers and it raises (K1 runs
    them on its long-view path, :func:`kernel_layout`). It reads no texel
    count, so a texel's rows do not depend on its batch."""
    if not 1 <= v <= max_views(n_angles):
        raise ValueError(
            f"V={v} views do not fit the fused VarPro kernel's registers "
            f"(1 to {max_views(n_angles)} views for {n_angles + 5} floats a view)")
    lanes = group_lanes(v, VIEWS_PER_LANE_BY_ANGLES[n_angles])
    return lanes, -(-v // lanes), THREADS // lanes


def kernel_layout(n_angles: int, v: int) -> tuple[int, int, int]:
    """The layout K1 runs ``v`` views in, for the wrapper and the plain
    version alike: :func:`lane_layout` (views in registers) up to
    :func:`max_views`, the long-view path's
    :func:`~brdf_tpu_torch.ops.lanegroup.long_view_layout` past it."""
    if v > max_views(n_angles):
        return long_view_layout(v, THREADS)
    return lane_layout(n_angles, v)


_P, _I, _F = _build.P, _build.I, _build.F
_FIT = _build.Entry("K1", "varpro", "brdf_varpro_fit", (
    _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I,
    _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P))
_OCCUPANCY = _build.Entry("K1", "varpro", "brdf_varpro_occupancy", (_I, _I, _I, _P))


def occupancy(model: str, v: int) -> dict:
    """What K1's instantiation for ``model`` at ``v`` views gets on the
    current card: its layout, resident blocks and warps an SM, registers and
    local-memory bytes a thread (the CUDA runtime's own figures)."""
    spec = SHADING_KERNELS[model]
    lanes, vpl, block_t = kernel_layout(len(spec.angle_names), v)
    res = _build.query(_OCCUPANCY, 4, spec.lobe_id, vpl, lanes)
    return dict(lanes=lanes, views_per_lane=vpl, block_t=block_t, blocks_per_sm=res[0],
                warps_per_sm=res[0] * res[3] // 32, registers=res[1], local_bytes=res[2])


def varpro_rows_cuda(cfg: VarProConfig, ang, y, w, sig0, iters: int) -> torch.Tensor:
    """Launch K1 on ``(V, T)`` CUDA inputs → the ``(8, T)`` output rows."""
    global LAUNCHES
    a_count, v, t = ang.shape
    _build.check_operands("K1", ang, y, w, *(() if sig0 is None else (sig0,)))
    spec = SHADING_KERNELS[cfg.model]
    if a_count != len(spec.angle_names) or y.shape != (v, t) or w.shape != (v, t):
        raise ValueError(f"K1 shapes: ang {tuple(ang.shape)}, y {tuple(y.shape)}, w {tuple(w.shape)}")
    if sig0 is not None and sig0.shape != (t,):
        raise ValueError(f"K1 takes a (T,) sigma start, got {tuple(sig0.shape)}")
    if t >= 2**31 // 8 or v > 2**31 - 32:
        raise ValueError(f"K1 indexes texels and views with 32-bit ints; "
                         f"T={t}, V={v} is too large")
    lanes, vpl, _ = kernel_layout(a_count, v)
    out = torch.empty((8, t), dtype=torch.float32, device=ang.device)
    if t == 0:
        return out
    span = float(cfg.s_hi - cfg.s_lo)
    n = len(cfg.grid_sig)
    grid_sig = (ctypes.c_float * n)(*cfg.grid_sig)
    grid_t = (ctypes.c_float * n)(*cfg.grid_t)
    _build.launch(
        _FIT, ang.device, spec.lobe_id, ang.data_ptr(), y.data_ptr(), w.data_ptr(),
        None if sig0 is None else sig0.data_ptr(), out.data_ptr(),
        t, v, lanes, vpl, grid_sig, grid_t, n,
        *cfg.box, int(cfg.use_log), cfg.s_lo, cfg.s_hi, cfg.p0_lo, cfg.p0_hi,
        span, 0.25 * span, 1e-6 * span, int(iters),
    )
    LAUNCHES += 1
    return out


def rows_to_result(out: torch.Tensor) -> VarProResult:
    return VarProResult(
        p=torch.stack([out[0], out[1], out[2]], dim=-1),
        chi2=out[3],
        iters=out[4].to(torch.int32),
        stop=out[5].to(torch.int32),
        g_abs=out[6],
    )


def varpro_fit_fused(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,              # (T, V)
    weights: torch.Tensor | None = None,
    p0: torch.Tensor | None = None,    # (T, 3) optional start (else grid init)
    iters: int = 6,
    lower: tuple | None = None,
    upper: tuple | None = None,
    grid_points: int = 8,
) -> VarProResult:
    """The fused VarPro solve: K1 for CUDA tensors, its plain version for
    CPU tensors. Same public contract as ``varpro_fit_pallas``."""
    cfg = config(model, lower, upper, grid_points)
    ang, y, w, sig0 = stack_inputs(model, angles, target, weights, p0)
    rows = (varpro_rows_cuda if _build.on_cuda(target, "the fused VarPro solve runs")
            else varpro_rows_plain)
    return rows_to_result(rows(cfg, ang, y, w, sig0, iters))
