"""Fused box-constrained Levenberg-Marquardt fit: CUDA kernel K5 and its
plain PyTorch version.

The kernel (``csrc/lm.cu``) replaces ``brdf_tpu/ops/lm_pallas.py::_lm_kernel``;
:func:`lm_rows_plain` mirrors it operation for operation on ``(V, T)``
tensors: per texel lane the whole box-projected LM solve for any of the ten
lobes (m = 1..5) — model and analytic Jacobian, JᵀJ and Jᵀr over the views,
projected-gradient norm, Kanzow μ init, active-set freeze, additive or
Marquardt damping, the closed-form damped solve, box projection, trial χ²,
predicted reduction, Nielsen's μ/ν control and the levmar stop codes, with
a warm ``(μ, ν, stop)`` resume. This is the one-solve-per-iteration variant
of ``solver/lm.py::levmar_bc`` (a rejected step grows μ and the next
iteration solves again).

:func:`lm_fit_fused` takes the public texel-major ``(T, V)`` layout of
``lm_fit_pallas`` and transposes once to the views-major layout both
versions run on. For CUDA tensors it launches K5 (and counts the launch in
:data:`LAUNCHES`); for CPU tensors it runs the plain version. It never
falls back from one to the other. :func:`lm_fit_compacted` is
``lm_fit_pallas_compacted``: two fused fits around plain gathers and
scatters.

On the card K5 is bound by FP32 and special-function issue, not by bytes
(see the note in ``csrc/lm.cu``): every texel reads its inputs once and
evaluates its lobe ``2·V`` times per iteration, for as many iterations as
its own solve takes. K5 solves a texel with a group of S lanes, each holding
VPL of its views (:func:`lane_layout`), and hands texels out to groups as
they finish theirs; it sums over views in the layout's fixed order
(``ops/lanegroup.py::group_sum``), and so does the plain version, so the two
agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import ShadingAngles
from brdf_tpu_torch.ops import _build
from brdf_tpu_torch.ops.lanegroup import group_lanes, group_sum
from brdf_tpu_torch.ops.shading import SHADING_KERNELS, ShadingKernelSpec
from brdf_tpu_torch.solver.lm import LMOptions, StopReason

# Every registry lobe fits the fused path (m ≤ MAX_PARAMS); kept as the
# membership check parallel/fit.py's engine="auto" keys off.
PALLAS_MODELS: dict[str, ShadingKernelSpec] = dict(SHADING_KERNELS)
MAX_PARAMS = 5          # the fused whole-solve kernel (K5)
MAX_SOLVE_PARAMS = 9    # the unrolled-Cholesky damped solve (the m=9 joint fit included)
_TINY = 1e-30
# Shared memory a block may use on Hopper (sm_90), opt-in dynamic maximum: the
# first K5 staged 32 texels' views in it, which set the view counts it takes
# (fits_fused); the K5/K6 routing keeps them.
SMEM_LIMIT = 232448
# K5's block: four warps (csrc/lm.cu kThreads)
THREADS = 128
# Views a lane holds while a group of up to 32 lanes can take the views (see
# lane_layout), by the lobe's angle channels: 4, (S, VPL) = (4, 4) at V=16,
# the fastest of five layouts timed on an H100 for ward_aniso and
# cook_torrance_aniso (PERF.md, the K5 findings); 2 for the two-channel lobes, whose
# (4, 4) sum order moves a CPU test of blinn_phong off its premise (ROADMAP.md
# Queue C).
VIEWS_PER_LANE = 4
VIEWS_PER_LANE_BY_ANGLES = {2: 2}
# A lane keeps its views in registers while they take at most this many
# floats (A + 2 a view: angles, y, w; csrc/lm.cu instantiates 1 and 2 slots);
# past it they are staged in shared memory, which keeps the registers a
# thread down and the warps an SM up (PERF.md, the K5 findings).
REGISTER_FLOATS = 8
# Hand texels out to lane groups as they finish (a persistent grid and a work
# counter) rather than one group a texel; chip_smoke.py times both.
REFILL = True
# Kernel launches made by lm_rows_cuda since the count was last reset.
LAUNCHES = 0

_DEFAULT_OPTS = LMOptions(eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=30)


class PallasFitResult(NamedTuple):
    p: torch.Tensor       # (T, m)
    chi2: torch.Tensor    # (T,)
    iters: torch.Tensor   # (T,) float32
    stop: torch.Tensor    # (T,) int32
    g_inf: torch.Tensor   # (T,)
    mu: torch.Tensor      # (T,) final damping (resume state)
    nu: torch.Tensor      # (T,) final damping growth factor (resume state)


class LMConfig(NamedTuple):
    """Everything static about one solve, as the float32 values that reach
    both versions (a constant rounded once cannot round differently)."""

    model: str
    lower: tuple[float, ...]
    upper: tuple[float, ...]
    eps1: float
    eps2_sq: float
    eps3: float
    mu_max: float
    half_mu_max: float
    tau: float
    itmax: int
    marquardt: bool


def _f32(x: float) -> float:
    return float(np.float32(x))


def config(model: str, opts: LMOptions, lower, upper) -> LMConfig:
    if model not in PALLAS_MODELS:
        raise ValueError(f"the fused LM solve supports the kernel lobes, got {model!r}")
    m = PALLAS_MODELS[model].n_params
    if len(lower) != m or len(upper) != m:
        raise ValueError(f"{model} has {m} params; got bounds {lower}/{upper}")
    return solve_config(model, opts, lower, upper)


def solve_config(model: str, opts: LMOptions, lower, upper) -> LMConfig:
    """:func:`config` without the check that the box has the lobe's size (the
    joint fit's box has nine entries around a three-parameter lobe)."""
    if opts.damping not in ("add", "marquardt"):
        raise ValueError(f"unknown damping {opts.damping!r}")
    with np.errstate(over="ignore"):
        eps2 = np.float32(opts.eps2)
        mu_max = np.float32(opts.mu_max)
        return LMConfig(
            model=model,
            lower=tuple(_f32(b) for b in lower), upper=tuple(_f32(b) for b in upper),
            eps1=_f32(opts.eps1), eps2_sq=float(eps2 * eps2), eps3=_f32(opts.eps3),
            mu_max=float(mu_max), half_mu_max=float(mu_max / np.float32(2.0)),
            tau=_f32(opts.tau), itmax=int(opts.itmax), marquardt=opts.damping == "marquardt",
        )


def stack_inputs(model: str, angles: ShadingAngles, target, p0, weights=None, warm=None):
    """Public ``(T, V)`` inputs → ``ang (A, V, T)``, ``y``/``w (V, T)`` and the
    start array ``(8, T)`` (rows 0..m−1 parameters, rows 5/6/7 the warm
    ``(μ, ν, stop)``; zeros are a cold start), all contiguous float32."""
    spec = PALLAS_MODELS[model]
    f32 = torch.float32
    t = target.shape[0]
    ang = torch.stack([getattr(angles, n).to(f32).T for n in spec.angle_names]).contiguous()
    y = target.to(f32).T.contiguous()
    w = torch.ones_like(y) if weights is None else weights.to(f32).T.contiguous()
    rows = torch.zeros((8, t), dtype=f32, device=target.device)
    rows[:spec.n_params] = p0.to(f32).T
    if warm is not None:
        for r, x in zip((5, 6, 7), warm):
            rows[r] = torch.as_tensor(x, device=target.device).to(f32)
    return ang, y, w, rows


def _solve_damped(af: dict, gf: list, m: int):
    """Closed-form symmetric m×m solve ``dp = −Af⁻¹ gf`` per lane; ``af[(j, k)]``
    (j ≤ k) are ``(1, T)`` rows. Returns (dp list, solver_ok mask)."""
    one = torch.ones_like(gf[0])
    zero = torch.zeros_like(gf[0])

    def inverse(det):
        ok = torch.abs(det) > _TINY
        return torch.where(ok, torch.reciprocal(torch.where(ok, det, one)), zero), ok

    if m == 1:
        inv, ok = inverse(af[(0, 0)])
        return [-gf[0] * inv], ok
    if m == 2:
        inv, ok = inverse(af[(0, 0)] * af[(1, 1)] - af[(0, 1)] * af[(0, 1)])
        dp0 = -(af[(1, 1)] * gf[0] - af[(0, 1)] * gf[1]) * inv
        dp1 = -(af[(0, 0)] * gf[1] - af[(0, 1)] * gf[0]) * inv
        return [dp0, dp1], ok
    if m == 3:
        c00 = af[(1, 1)] * af[(2, 2)] - af[(1, 2)] * af[(1, 2)]
        c01 = af[(0, 2)] * af[(1, 2)] - af[(0, 1)] * af[(2, 2)]
        c02 = af[(0, 1)] * af[(1, 2)] - af[(0, 2)] * af[(1, 1)]
        c11 = af[(0, 0)] * af[(2, 2)] - af[(0, 2)] * af[(0, 2)]
        c12 = af[(0, 1)] * af[(0, 2)] - af[(0, 0)] * af[(1, 2)]
        c22 = af[(0, 0)] * af[(1, 1)] - af[(0, 1)] * af[(0, 1)]
        inv, ok = inverse(af[(0, 0)] * c00 + af[(0, 1)] * c01 + af[(0, 2)] * c02)
        return [
            -(c00 * gf[0] + c01 * gf[1] + c02 * gf[2]) * inv,
            -(c01 * gf[0] + c11 * gf[1] + c12 * gf[2]) * inv,
            -(c02 * gf[0] + c12 * gf[1] + c22 * gf[2]) * inv,
        ], ok
    if m > MAX_SOLVE_PARAMS:
        raise ValueError(f"unsupported parameter count m={m}")
    # Cholesky A = L Lᵀ, unrolled; a pivot at or below _TINY flags the lane.
    # Every sum starts from 0 and runs upward, as the kernel's does.
    tiny = zero + _TINY
    l = {}
    ok = torch.ones_like(zero, dtype=torch.bool)
    for j in range(m):
        v = af[(j, j)] - sum((l[(j, k)] * l[(j, k)] for k in range(j)), zero)
        ok = ok & (v > _TINY)
        l[(j, j)] = torch.sqrt(torch.maximum(v, tiny))
        for i in range(j + 1, m):
            l[(i, j)] = (af[(j, i)] - sum((l[(i, k)] * l[(j, k)] for k in range(j)), zero)) / l[(j, j)]
    y = []
    for i in range(m):                      # forward: L y = −g
        y.append((-gf[i] - sum((l[(i, k)] * y[k] for k in range(i)), zero)) / l[(i, i)])
    dp: list = [None] * m
    for i in reversed(range(m)):            # backward: Lᵀ dp = y
        dp[i] = (y[i] - sum((l[(k, i)] * dp[k] for k in range(i + 1, m)), zero)) / l[(i, i)]
    okf = ok.to(zero.dtype)
    return [d * okf for d in dp], ok


def lm_rows_plain(cfg: LMConfig, ang, y, w, p0_rows) -> torch.Tensor:
    """K5's plain version on ``(V, T)`` inputs → the ``(16, T)`` output rows
    (0..4 parameters, 5 χ², 6 iterations, 7 stop, 8 g_inf, 9 μ, 10 ν).

    Lanes are columns; the loop runs while any lane is active and a lane
    that has stopped keeps its state, which is what the kernel's groups do
    when their texel stops (they write it and take another). Every sum over
    views is :func:`~brdf_tpu_torch.ops.lanegroup.group_sum` at
    :func:`lane_layout`'s layout, the kernel's order."""
    spec = PALLAS_MODELS[cfg.model]
    m = spec.n_params
    angles = tuple(ang[a] for a in range(ang.shape[0]))
    w2 = w * w
    lb, ub = cfg.lower, cfg.upper
    lanes, vpl, _ = lane_layout(ang.shape[0], ang.shape[1])

    def rsum(x):
        return group_sum(x, lanes, vpl)

    def psum(terms, zero):
        # a sum over parameters, from 0 upward
        acc = zero
        for x in terms:
            acc = acc + x
        return acc

    def chi2_of(p):
        i_val, _, _ = spec.eval(angles, tuple(p))
        r = (i_val - y) * w
        return rsum(r * r)

    p = [torch.clamp(p0_rows[j:j + 1], lb[j], ub[j]) for j in range(m)]
    chi2 = chi2_of(p)
    zero = torch.zeros_like(chi2)
    third = zero + 1.0 / 3.0
    tiny = zero + _TINY

    mu_w = p0_rows[5:6]
    mu = torch.where(torch.isfinite(mu_w) & (mu_w > 0), mu_w, zero)
    nu_w = p0_rows[6:7]
    nu = torch.where(torch.isfinite(nu_w) & (nu_w >= 2.0), nu_w, zero + 2.0)
    stop_w = p0_rows[7:8]
    stop0 = torch.where(torch.isfinite(chi2), zero, zero + float(StopReason.INVALID_VALUES))
    stop = torch.where(stop_w != 0.0, stop_w, stop0)
    it = zero.clone()
    g_inf = zero + 3.4e38

    while True:
        act = (stop == 0.0) & (it < float(cfg.itmax))
        if not bool(act.any()):
            break
        i_val, d, _ = spec.eval(angles, tuple(p))
        r = (i_val - y) * w

        a = {}
        for j in range(m):
            for k in range(j, m):
                a[(j, k)] = rsum(d[j] * d[k] * w2)
        g = [rsum(d[j] * r * w) for j in range(m)]

        pg = [torch.abs(p[j] - torch.clamp(p[j] - g[j], lb[j], ub[j])) for j in range(m)]
        gi = functools.reduce(torch.maximum, pg)
        grad_conv = gi <= cfg.eps1

        max_diag = functools.reduce(torch.maximum, [a[(j, j)] for j in range(m)])
        mu0 = zero + cfg.tau if cfg.marquardt else cfg.tau * max_diag
        mu_it = torch.where((it == 0.0) & (mu <= 0.0), mu0, mu)

        frozen = [((p[j] <= lb[j]) & (g[j] > 0)) | ((p[j] >= ub[j]) & (g[j] < 0)) for j in range(m)]
        free = [torch.where(frozen[j], zero, zero + 1.0) for j in range(m)]
        af = {}
        for j in range(m):
            damp = mu_it * (a[(j, j)] + 1e-8 * max_diag + _TINY) if cfg.marquardt else mu_it
            af[(j, j)] = torch.where(frozen[j], zero + 1.0, a[(j, j)] + damp)
        for j in range(m):
            for k in range(j + 1, m):
                af[(j, k)] = a[(j, k)] * free[j] * free[k]
        gf = [g[j] * free[j] for j in range(m)]

        dp, solver_ok = _solve_damped(af, gf, m)

        pn = [torch.clamp(p[j] + dp[j], lb[j], ub[j]) for j in range(m)]
        dpa = [pn[j] - p[j] for j in range(m)]           # the projected step
        dp_nrm2 = psum((x * x for x in dpa), zero)
        p_nrm2 = psum((x * x for x in p), zero)
        small_dp = dp_nrm2 <= cfg.eps2_sq * p_nrm2

        chi2_new = chi2_of(pn)
        finite = torch.isfinite(chi2_new)
        df = chi2 - chi2_new

        # predicted reduction −(2 gᵀδ + δᵀ JᵀJ δ) with the unfrozen system
        q = [psum((a[(min(j, k), max(j, k))] * dpa[k] for k in range(m)), zero) for j in range(m)]
        g_dot = psum((g[j] * dpa[j] for j in range(m)), zero)
        q_dot = psum((dpa[j] * q[j] for j in range(m)), zero)
        dl = -(2.0 * g_dot + q_dot)

        accept = solver_ok & finite & (df > 0)
        rho = torch.where(dl > 0, df / torch.maximum(dl, tiny), zero + 1.0)
        tmp = 2.0 * rho - 1.0
        mu_next = torch.where(accept, mu_it * torch.maximum(third, 1.0 - tmp * tmp * tmp), mu_it * nu)
        nu_next = torch.where(accept, zero + 2.0, nu * 2.0)

        # stop codes: later assignments win (convergence over failure)
        st = zero
        st = torch.where(mu_next > cfg.mu_max, zero + float(StopReason.NO_REDUCTION), st)
        st = torch.where((~solver_ok) & (mu_it > cfg.half_mu_max),
                         zero + float(StopReason.SINGULAR), st)
        st = torch.where(small_dp & solver_ok, zero + float(StopReason.SMALL_DP), st)
        chi2_sel = torch.where(accept, chi2_new, chi2)
        st = torch.where(chi2_sel <= cfg.eps3, zero + float(StopReason.SMALL_CHI2), st)
        st = torch.where(grad_conv, zero + float(StopReason.SMALL_GRADIENT), st)

        p = [torch.where(act & accept, pn[j], p[j]) for j in range(m)]
        chi2 = torch.where(act, chi2_sel, chi2)
        mu = torch.where(act, mu_next, mu)
        nu = torch.where(act, nu_next, nu)
        it = torch.where(act, it + 1.0, it)
        stop = torch.where(act, st, stop)
        g_inf = torch.where(act, gi, g_inf)

    stop_out = torch.where(stop == 0.0, zero + float(StopReason.MAX_ITERATIONS), stop)
    rows = p + [zero] * (MAX_PARAMS - m) + [chi2, it, stop_out, g_inf, mu, nu] + [zero] * 5
    return torch.cat(rows)


def fits_fused(n_angles: int, v: int) -> bool:
    """Whether K5 takes ``v`` views: V ≤ 165 for a nine-channel lobe, V ≤ 363
    for cook_torrance, V ≤ 454 for blinn_phong — the counts whose views the
    first K5 could stage for 32 texels in a block's shared memory. The
    redesigned K5 keeps them, so that the K5/K6 routing of ``parallel/fit.py``
    does not move; past them runs the chunked tier."""
    return (n_angles + 2) * v * 32 * 4 <= SMEM_LIMIT


def views_per_lane(n_angles: int) -> int:
    """The most views a lane of K5 holds before a texel takes more lanes."""
    return VIEWS_PER_LANE_BY_ANGLES.get(n_angles, VIEWS_PER_LANE)


def lane_layout(n_angles: int, v: int) -> tuple[int, int, int]:
    """K5's layout for ``v`` views → ``(S, VPL, block_t)``: S lanes a texel (a
    power of two that divides 32), VPL = ⌈v / S⌉ views a lane (lane l holds
    views l, l + S, …), ``block_t`` = 128 / S texels a block in flight. S is
    the smallest that gives a lane at most :func:`views_per_lane` views, or
    32. The kernel and the plain version both sum in this layout's order.
    Past :func:`fits_fused` it raises: such a view count belongs to the
    chunked tier, which ``parallel/fit.py`` then chooses by itself."""
    if v < 1 or not fits_fused(n_angles, v):
        raise ValueError(
            f"V={v} views are not taken by the fused LM kernel (1 to the views whose "
            f"{n_angles + 2} floats a view fit {SMEM_LIMIT} bytes for 32 texels); "
            "use ops/ne.py::lm_fit_chunked, which streams the views")
    lanes = group_lanes(v, views_per_lane(n_angles))
    return lanes, -(-v // lanes), THREADS // lanes


def register_slots(n_angles: int, vpl: int) -> int:
    """Where K5 keeps a lane's ``vpl`` views: in ``vpl`` register slots while
    they take at most ``REGISTER_FLOATS`` floats, else 0 — staged in shared
    memory, each lane in its own column."""
    return vpl if vpl * (n_angles + 2) <= REGISTER_FLOATS else 0


_P, _I, _F = _build.P, _build.I, _build.F
_FIT = _build.Entry("K5", "lm", "brdf_lm_fit", (
    _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I,
    _P))
_OCCUPANCY = _build.Entry("K5", "lm", "brdf_lm_occupancy", (_I, _I, _I, _I, _P))


def occupancy(model: str, v: int) -> dict:
    """What K5's instantiation for ``model`` at ``v`` views gets on the
    current card: its layout, register slots (0: staged), resident blocks and
    warps an SM, registers and local-memory bytes a thread, and the grid the
    refill launches (the CUDA runtime's own figures)."""
    spec = PALLAS_MODELS[model]
    lanes, vpl, block_t = lane_layout(len(spec.angle_names), v)
    slots = register_slots(len(spec.angle_names), vpl)
    res = _build.query(_OCCUPANCY, 5, spec.lobe_id, slots, lanes, v)
    return dict(lanes=lanes, views_per_lane=vpl, block_t=block_t, slots=slots,
                blocks_per_sm=res[0], warps_per_sm=res[0] * res[3] // 32, registers=res[1],
                local_bytes=res[2], persistent_blocks=res[0] * res[4])


def lm_rows_cuda(cfg: LMConfig, ang, y, w, p0_rows, counters=None) -> torch.Tensor:
    """Launch K5 on ``(V, T)`` CUDA inputs → the ``(16, T)`` output rows.
    ``counters``, an int32 CUDA tensor of 2 the caller may pass to read them
    afterwards, is zeroed here: [0] the work counter, [1] the warps' trips."""
    global LAUNCHES
    a_count, v, t = ang.shape
    _build.check_operands("K5", ang, y, w, p0_rows)
    spec = PALLAS_MODELS[cfg.model]
    if (a_count != len(spec.angle_names) or y.shape != (v, t) or w.shape != (v, t)
            or p0_rows.shape != (8, t)):
        raise ValueError(f"K5 shapes: ang {tuple(ang.shape)}, y {tuple(y.shape)}, "
                         f"w {tuple(w.shape)}, p0 {tuple(p0_rows.shape)}")
    if t >= 2**31 // 16:
        raise ValueError(f"K5 indexes texels with 32-bit ints; T={t} is too large")
    lanes, vpl, _ = lane_layout(a_count, v)
    out = torch.empty((16, t), dtype=torch.float32, device=ang.device)
    if t == 0:
        return out
    if counters is None:
        counters = torch.zeros(2, dtype=torch.int32, device=ang.device)
    elif (not counters.is_cuda or counters.dtype != torch.int32 or counters.shape != (2,)
          or counters.device != ang.device):
        raise ValueError("K5's counters are an int32 CUDA tensor of 2 on the inputs' device")
    else:
        counters.zero_()
    m = spec.n_params
    lower = (ctypes.c_float * m)(*cfg.lower)
    upper = (ctypes.c_float * m)(*cfg.upper)
    _build.launch(
        _FIT, ang.device, spec.lobe_id, ang.data_ptr(), y.data_ptr(), w.data_ptr(),
        p0_rows.data_ptr(), out.data_ptr(), counters.data_ptr(), t, v, lanes,
        register_slots(a_count, vpl), int(REFILL), lower, upper, m, cfg.eps1, cfg.eps2_sq,
        cfg.eps3, cfg.mu_max, cfg.half_mu_max, cfg.tau, cfg.itmax, int(cfg.marquardt),
    )
    LAUNCHES += 1
    return out


def rows_to_result(out: torch.Tensor, m: int) -> PallasFitResult:
    return PallasFitResult(
        p=out[0:m].T, chi2=out[5], iters=out[6], stop=out[7].to(torch.int32),
        g_inf=out[8], mu=out[9], nu=out[10],
    )


def lm_fit_fused(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,              # (T, V)
    p0: torch.Tensor,                  # (T, m)
    weights: torch.Tensor | None = None,
    opts: LMOptions = _DEFAULT_OPTS,
    lower: tuple = (0.0, 0.0, 0.0),
    upper: tuple = (100.0, 100.0, 100.0),
    warm: tuple | None = None,
) -> PallasFitResult:
    """Fit T independent m-parameter lobes: K5 for CUDA tensors, its plain
    version for CPU tensors. Same public contract as ``lm_fit_pallas``:
    ``warm`` is an optional ``(μ, ν, stop)`` triple of (T,) tensors resuming
    the damping state (μ ≤ 0 lanes take the Kanzow init, stop ≠ 0 lanes
    short-circuit and are returned as they came)."""
    cfg = config(model, opts, lower, upper)
    # a view count the kernel does not take is refused on either device
    lane_layout(len(PALLAS_MODELS[model].angle_names), target.shape[1])
    ang, y, w, rows = stack_inputs(model, angles, target, p0, weights, warm)
    fit = lm_rows_cuda if _build.on_cuda(target, "the fused LM solve runs") else lm_rows_plain
    return rows_to_result(fit(cfg, ang, y, w, rows), PALLAS_MODELS[model].n_params)


def lm_fit_compacted(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,              # (T, V)
    p0: torch.Tensor,                  # (T, m)
    weights: torch.Tensor | None = None,
    opts: LMOptions = LMOptions(eps1=1e-9, eps2=1e-9, eps3=1e-14, itmax=60),
    lower: tuple = (0.0, 0.0, 0.0),
    upper: tuple = (100.0, 100.0, 100.0),
    block_t: int = 1024,
    first_itmax: int = 8,
    tail_frac: int = 8,
    select_chi2: float | None = None,
) -> PallasFitResult:
    """Two-phase fused fit with tail compaction (``lm_fit_pallas_compacted``).

    Phase 1 runs every lane for ``first_itmax`` iterations. The lanes still
    at ``MAX_ITERATIONS`` (or, with ``select_chi2``, those whose χ² exceeds
    it) are gathered into a slab of static size ``max(block_t, T // tail_frac)``
    and resumed with the full ``opts.itmax`` and their (μ, ν); lanes that
    had stopped otherwise restart their damping. Results scatter back. A
    tail larger than the slab keeps its phase-1 result beyond the slab, and
    slab slots past the tail are filled with the last texel at zero weight
    and dropped, as ``jnp.nonzero(size=, fill_value=T)`` and a scatter with
    ``mode="drop"`` do. ``block_t`` only sizes the slab here."""
    r1 = lm_fit_fused(model, angles, target, p0, weights=weights,
                      opts=opts._replace(itmax=first_itmax), lower=lower, upper=upper)
    t = target.shape[0]
    cap = max(block_t, t // tail_frac)
    max_it = int(StopReason.MAX_ITERATIONS)
    if select_chi2 is not None:
        active = r1.chi2 > float(np.float32(select_chi2))
    else:
        active = r1.stop == max_it
    found = torch.nonzero(active)[:cap, 0]
    idx = torch.full((cap,), t, dtype=torch.long, device=target.device)
    idx[:found.shape[0]] = found
    idx_c = torch.clamp(idx, max=t - 1)
    valid = idx < t

    if weights is None:
        weights = torch.ones_like(target)
    ang_g = ShadingAngles(*(None if a is None else a[idx_c] for a in angles))
    w_g = weights[idx_c] * valid[:, None].to(weights.dtype)
    still_running = r1.stop[idx_c] == max_it
    warm = (
        torch.where(still_running, r1.mu[idx_c], torch.zeros_like(r1.mu[idx_c])),
        torch.where(still_running, r1.nu[idx_c], torch.full_like(r1.nu[idx_c], 2.0)),
        torch.zeros((cap,), dtype=torch.float32, device=target.device),
    )
    r2 = lm_fit_fused(model, ang_g, target[idx_c], r1.p[idx_c], weights=w_g, opts=opts,
                      lower=lower, upper=upper, warm=warm)

    keep = idx[valid]

    def scatter(base, new):
        out = base.clone()
        out[keep] = new[valid]
        return out

    return PallasFitResult(
        p=scatter(r1.p, r2.p),
        chi2=scatter(r1.chi2, r2.chi2),
        iters=scatter(r1.iters, r1.iters[idx_c] + r2.iters),
        stop=scatter(r1.stop, r2.stop),
        g_inf=scatter(r1.g_inf, r2.g_inf),
        mu=scatter(r1.mu, r2.mu),
        nu=scatter(r1.nu, r2.nu),
    )
