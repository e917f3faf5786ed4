"""Chunked LM tier: the normal-equation kernels K6 and K7, their plain PyTorch
versions and the eager LM control loop they share.

K6 (``csrc/ne.cu``) replaces ``brdf_tpu/ops/lm_pallas.py::_ne_kernel`` and K7
(``csrc/joint_ne.cu``) ``::_joint_ne_kernel``. Both accumulate per-texel
normal equations over the view axis — χ², the upper triangle of JᵀW²J and
JᵀW²e — in the modes ``"chi2"``, ``"grad"`` and ``"full"``; K6 for a lobe on
fixed angles (any of the ten, m = 1..5), K7 for the m = 9 joint normal-map
model, whose cosines depend on the fitted normal offset and are computed in
the kernel from the light and eye vectors. :func:`ne_rows_plain` and
:func:`joint_ne_rows_plain` mirror them operation for operation on
views-major tensors (the CPU path, and what the kernels are held against on
the card); :func:`ne_rows` and :func:`joint_ne_rows` launch the kernel for
CUDA tensors (counting the launch in :data:`LAUNCHES`) and run the plain
version for CPU tensors. Neither stands in for the other.

On the TPU the view axis is cut into chunks that fit the fast memory and the
texel axis into blocks; on the GPU a texel's views are split over the W warps
of a block that share 32 texels (W = 1 is one thread walking every view),
each adding its views left to right from 0, and the W partials meet as a
pairwise tree. :func:`ne_layout` picks W from the kernel, m, the mode and V,
and the wrappers and the plain versions both call it, so they sum in one
order (``ops/lanegroup.py::group_sum``). So ``view_block`` and ``block_t``
are gone from every signature here, nothing is padded, and the view count is
unbounded by construction. There is no ``interpret`` either. With
``axis_name`` (a view axis sharded over the ranks of the current mesh,
``parallel/mesh.py``) each rank launches the kernel on its own views and the
rows are ``axis_sum``med before the solve, as the JAX package ``psum``s them
(``lm_pallas.py:538-539, 1154-1155``); its ``overlap_slices``, which cut the
texels into chains so that one slice's all-reduce overlaps the next slice's
kernel, stay out: the JAX package measured them slower at 16 views and left
them off by default (``lm_pallas.py:500-509``).

:func:`chunked_lm_loop` is ``_chunked_lm_loop``: the box-projected LM of
``ops/lm.py`` (one solve per iteration, Kanzow μ init, active-set freeze,
Nielsen μ/ν, the levmar stop codes, the warm ``(μ, ν, stop)`` resume) on
``(T,)`` lanes, four launches an iteration: the normal equations at the
current point, the step kernel that proposes the trial point, χ² at the
trial point and the step kernel that accepts it (``csrc/lm_step.cu``;
:func:`lm_step_propose` and :func:`lm_step_accept`, their plain versions
:func:`lm_step_propose_plain` and :func:`lm_step_accept_plain` on the CPU).
Its ``while any(active)`` is one host synchronisation per iteration
(:data:`LOOP_SYNCS` counts them). On top of it sit the public functions with
the JAX package's contracts: :func:`lm_fit_chunked`
(``lm_fit_pallas_chunked``), :func:`shading_value_and_grad`,
:func:`lm_fit_joint_chunked` and :func:`joint_value_and_grad`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from brdf_tpu_torch.models.brdf import ShadingAngles, ShadingGeometry
from brdf_tpu_torch.models.normalmap import tangent_basis
from brdf_tpu_torch.ops import _build
from brdf_tpu_torch.ops.lanegroup import group_sum
from brdf_tpu_torch.ops.lm import (
    _DEFAULT_OPTS,
    _TINY,
    PALLAS_MODELS,
    LMConfig,
    PallasFitResult,
    _solve_damped,
    config,
    solve_config,
)
from brdf_tpu_torch.ops.shading import SHADING_KERNELS
from brdf_tpu_torch.parallel.mesh import axis_sum
from brdf_tpu_torch.solver.lm import LMOptions, StopReason
from brdf_tpu_torch.utils import profiling
from brdf_tpu_torch.utils.profiling import span

_EPS = 1e-12
MODES = {"chi2": 0, "grad": 1, "full": 2}
JOINT_M = 9
# base lobes of the joint kernel: the four with (kd, ks, shape) parameters
JOINT_MODELS = tuple(n for n, s in SHADING_KERNELS.items() if s.n_params == 3)
# Kernel launches since the counts were last reset: K6 ("ne"), K7 ("joint_ne")
# and the eager LM loop's step kernels ("lm_step", csrc/lm_step.cu: two a pass).
LAUNCHES = {"ne": 0, "joint_ne": 0, "lm_step": 0}
# Host synchronisations made by chunked_lm_loop's ``any(active)`` test.
LOOP_SYNCS = 0
# The parameter counts the step kernels are built for: K6's lobes and the joint
# model. Rows of a solve's lane state and of a pass's scratch, as
# csrc/lm_step.cu indexes them.
STEP_PARAMS = (1, 2, 3, 4, 5, JOINT_M)
STATE_ROWS = ("chi2", "mu", "nu", "iters", "stop", "g_inf")
SCRATCH_ROWS = ("mu_it", "grad_norm", "pred_reduction", "solver_ok", "small_dp", "grad_conv")

# The joint normal-map fit's solver options where the caller gives none
# (pipeline/fit.py::fit_joint_normalmap and lm_fit_joint_chunked).
JOINT_OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=40)


def ne_rows_count(m: int, mode: str) -> int:
    """Rows of the output: χ², then in ``full`` the m(m+1)/2 entries of JᵀJ,
    then in ``grad`` and ``full`` the m of Jᵀe."""
    return {"chi2": 1, "grad": 1 + m, "full": 1 + m * (m + 1) // 2 + m}[mode]


# W, the warps a texel's views are split over (csrc/lanegroup.cuh): a power of
# two up to MAX_WARPS whose partials, R · W · 32 floats, fit SMEM_LIMIT, the
# default 48 KB a block (the kernels ask for no more). W = 1 is one thread a
# texel.
ONE_THREAD = 1
MAX_WARPS = 8
SMEM_LIMIT = 48 * 1024
# never fewer views a warp than this: at 16 views a split only adds the
# per-texel set-up and the combine (PERF.md)
MIN_VIEWS_PER_PART = 16


def ne_layout(kernel: str, m: int, mode: str, v: int) -> int:
    """The warps W a texel's views are split over in K6 (``kernel="ne"``, an
    m-parameter lobe) or K7 (``"joint_ne"``, m = 9) in ``mode`` at ``v``
    views: a pure function, so that the CUDA wrapper and the plain version
    sum in the same order. The most warps :func:`layout_fits` allows that
    keep ``MIN_VIEWS_PER_PART`` views a warp; one thread a texel below
    2 · ``MIN_VIEWS_PER_PART`` views. It reads no texel count, so a texel's
    rows do not depend on the batch it is fitted in."""
    if kernel not in ("ne", "joint_ne") or mode not in MODES:
        raise ValueError(f"no layout for kernel {kernel!r} in mode {mode!r}")
    warps = ONE_THREAD
    while v >= 2 * warps * MIN_VIEWS_PER_PART and layout_fits(m, mode, 2 * warps):
        warps *= 2
    return warps


def layout_fits(m: int, mode: str, warps: int) -> bool:
    """Whether K6 or K7 (m = 9) take a split of ``warps`` in ``mode``: a
    power of two up to ``MAX_WARPS`` whose partials fit ``SMEM_LIMIT``."""
    return (1 <= warps <= MAX_WARPS and not warps & (warps - 1)
            and ne_rows_count(m, mode) * warps * 32 * 4 <= SMEM_LIMIT)


def _layout_sum(warps: int, v: int):
    """Σ over the view axis in a split of ``warps``'s order (``group_sum``; a
    list of terms adds them in list order within each view) → the ``(...)``
    sum."""
    vpl = -(-v // warps)
    return lambda terms: group_sum(terms, warps, vpl)[0]


# ---------------------------------------------------------------------------
# K6: a lobe on fixed angles
# ---------------------------------------------------------------------------


def ne_rows_plain(model: str, mode: str, ang, y, w, p_rows) -> torch.Tensor:
    """K6's plain version: ``ang (A, V, T)``, ``y (V, T)``, ``w (V, T)`` or
    ``None``, ``p_rows (m, T)`` → ``(R, T)`` rows: χ², then (j, k) for j ≤ k,
    then g (see :func:`ne_rows_count`), each summed over the views in
    :func:`ne_layout`'s order."""
    spec = SHADING_KERNELS[model]
    m = spec.n_params
    v = y.shape[0]
    view_sum = _layout_sum(ne_layout("ne", m, mode, v), v)
    i_val, d, _ = spec.eval(tuple(ang), tuple(p_rows[j:j + 1] for j in range(m)))
    if w is not None:
        r = (i_val - y) * w
        rw = r * w
        w2 = w * w
    else:
        r = i_val - y
        rw = r
    rows = [view_sum(r * r)]
    if mode == "full":
        for j in range(m):
            for k in range(j, m):
                dd = d[j] * d[k]
                rows.append(view_sum(dd * w2 if w is not None else dd))
    if mode in ("full", "grad"):
        rows.extend(view_sum(d[j] * rw) for j in range(m))
    return torch.stack(rows)


def _checked_layout(name: str, kernel: str, m: int, mode: str, v: int) -> int:
    warps = ne_layout(kernel, m, mode, v)
    if not layout_fits(m, mode, warps):
        raise ValueError(f"{name} does not take a split of {warps} warps in {mode} mode")
    return warps


_P, _I, _F = _build.P, _build.I, _build.F
_NE = _build.Entry("K6", "ne", "brdf_ne_rows", (_I,) * 3 + (_P,) * 5 + (_I, _I, _P))
_JOINT = _build.Entry("K7", "joint_ne", "brdf_joint_ne_rows", (_I,) * 3 + (_P,) * 6 + (_I, _I, _P))
_OCCUPANCY = {
    "ne": _build.Entry("K6", "ne", "brdf_ne_occupancy", (_I,) * 4 + (_P,)),
    "joint_ne": _build.Entry("K7", "joint_ne", "brdf_joint_ne_occupancy", (_I,) * 3 + (_P,)),
}


def occupancy(kernel: str, model: str, mode: str, warps: int, weighted: bool = True) -> dict:
    """What K6 (``kernel="ne"``) or K7 (``"joint_ne"``, ``model`` its base
    lobe) gets at a split of ``warps`` on the current card: resident blocks
    and warps an SM, registers and local-memory bytes a thread, threads a
    block (the CUDA runtime's own figures)."""
    res = _build.query(_OCCUPANCY[kernel], 4, SHADING_KERNELS[model].lobe_id, MODES[mode],
                       *((int(weighted),) if kernel == "ne" else ()), warps)
    return dict(warps=warps, blocks_per_sm=res[0], warps_per_sm=res[0] * res[3] // 32,
                registers=res[1], local_bytes=res[2], threads_per_block=res[3])


def ne_rows_cuda(model: str, mode: str, ang, y, w, p_rows) -> torch.Tensor:
    """Launch K6 on views-major CUDA inputs → the ``(R, T)`` rows. ``w=None``
    takes the variant that reads no weights."""
    spec = SHADING_KERNELS[model]
    m = spec.n_params
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {tuple(MODES)}")
    _build.check_operands("K6", ang, y, p_rows, *(() if w is None else (w,)))
    if ang.ndim != 3 or ang.shape[0] != len(spec.angle_names):
        raise ValueError(f"K6: {model} reads {len(spec.angle_names)} angle channels (A, V, T), "
                         f"got {tuple(ang.shape)}")
    _, v, t = ang.shape
    if y.shape != (v, t) or p_rows.shape != (m, t) or (w is not None and w.shape != (v, t)):
        raise ValueError(f"K6 shapes: ang {tuple(ang.shape)}, y {tuple(y.shape)}, "
                         f"w {None if w is None else tuple(w.shape)}, p {tuple(p_rows.shape)}")
    if t >= 2**31:
        raise ValueError(f"K6 covers fewer than 2^31 texels a launch, got T={t}")
    out = torch.empty((ne_rows_count(m, mode), t), dtype=torch.float32, device=ang.device)
    if t == 0:
        return out
    if v == 0:
        return out.zero_()
    warps = _checked_layout("K6", "ne", m, mode, v)
    _build.launch(_NE, ang.device, spec.lobe_id, MODES[mode], warps, ang.data_ptr(), y.data_ptr(),
                  None if w is None else w.data_ptr(), p_rows.data_ptr(), out.data_ptr(), t, v)
    LAUNCHES["ne"] += 1
    return out


def ne_rows(model: str, mode: str, ang, y, w, p_rows) -> torch.Tensor:
    """K6 for CUDA tensors, its plain version for CPU tensors."""
    if _build.on_cuda(ang, "the normal-equation kernels run"):
        return ne_rows_cuda(model, mode, ang, y, w, p_rows)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {tuple(MODES)}")
    return ne_rows_plain(model, mode, ang, y, w, p_rows)


# ---------------------------------------------------------------------------
# K7: the joint normal-map model
# ---------------------------------------------------------------------------


def _dot3(x, z):
    return x[0] * z[0] + x[1] * z[1] + x[2] * z[2]


def _inv_norm(x):
    """``1 / sqrt(max(x·x, eps))``, as the kernel writes it."""
    return torch.reciprocal(torch.sqrt(torch.clamp(_dot3(x, x), min=_EPS)))


def joint_ne_rows_plain(base_model: str, mode: str, lv, y, w, p_rows, frame) -> torch.Tensor:
    """K7's plain version: ``lv (6, V, T)`` light then eye unit vectors,
    ``y``/``w (3, V, T)`` per channel, ``p_rows (9, T)``, ``frame (9, T)`` =
    (n, t, b) → ``(R, T)`` rows of the m = 9 normal equations, R = 1, 10, 55,
    each summed in :func:`ne_layout`'s order with the three channels' terms
    added in order within a view. The 12 structurally zero entries of the 45
    are zeros."""
    spec = SHADING_KERNELS[base_model]
    m = JOINT_M
    p = [p_rows[j:j + 1] for j in range(m)]
    n3 = [frame[i:i + 1] for i in range(3)]
    t3 = [frame[3 + i:4 + i] for i in range(3)]
    b3 = [frame[6 + i:7 + i] for i in range(3)]

    # perturbed unit normal and its offset partials, per texel (1, T)
    u = [n3[i] + p[7] * t3[i] + p[8] * b3[i] for i in range(3)]
    inv_ell = _inv_norm(u)
    npn = [x * inv_ell for x in u]
    ndt = _dot3(npn, t3)
    ndb = _dot3(npn, b3)
    dn_du = [(t3[i] - npn[i] * ndt) * inv_ell for i in range(3)]
    dn_dv = [(b3[i] - npn[i] * ndb) * inv_ell for i in range(3)]

    ell = [lv[i] for i in range(3)]
    eye = [lv[3 + i] for i in range(3)]

    def dots(x):
        return _dot3(x, npn), _dot3(x, dn_du), _dot3(x, dn_dv)

    names = spec.angle_names
    angs = {"cos_ln": dots(ell)}
    cl, cl_du, cl_dv = angs["cos_ln"]
    if "cos_nh" in names:
        s = [ell[i] + eye[i] for i in range(3)]
        inv_s = _inv_norm(s)
        angs["cos_nh"] = dots([x * inv_s for x in s])
    if "cos_vn" in names or "cos_rv" in names:
        angs["cos_vn"] = dots(eye)
        cvn, cvn_du, cvn_dv = angs["cos_vn"]
    if "cos_rv" in names:
        # R·V = 2 (N·L)(N·V) − L·V; L·V does not depend on the normal
        angs["cos_rv"] = (2.0 * cl * cvn - _dot3(ell, eye),
                          2.0 * (cl_du * cvn + cl * cvn_du),
                          2.0 * (cl_dv * cvn + cl * cvn_dv))
    ang_vals = tuple(angs[nm][0] for nm in names)
    ang_dus = [angs[nm][1] for nm in names]
    ang_dvs = [angs[nm][2] for nm in names]

    chi2_terms = []
    g_terms: dict[int, list] = {}
    a_terms: dict[tuple, list] = {}
    for c in range(3):
        i_val, d_par, d_ang = spec.eval(ang_vals, (p[c], p[3 + c], p[6]))
        r = (i_val - y[c]) * w[c]
        chi2_terms.append(r * r)
        if mode == "chi2":
            continue
        d_nu = d_ang[0] * ang_dus[0]
        d_nv = d_ang[0] * ang_dvs[0]
        for a in range(1, len(names)):
            d_nu = d_nu + d_ang[a] * ang_dus[a]
            d_nv = d_nv + d_ang[a] * ang_dvs[a]
        cols = {c: d_par[0], 3 + c: d_par[1], 6: d_par[2], 7: d_nu, 8: d_nv}
        rw = r * w[c]
        for j, cj in cols.items():
            g_terms.setdefault(j, []).append(cj * rw)
        if mode == "full":
            w2 = w[c] * w[c]
            keys = sorted(cols)
            for ji, j in enumerate(keys):
                for k in keys[ji:]:
                    a_terms.setdefault((j, k), []).append(cols[j] * cols[k] * w2)

    view_sum = _layout_sum(ne_layout("joint_ne", m, mode, lv.shape[1]), lv.shape[1])
    rows = [view_sum(chi2_terms)]
    zero = torch.zeros_like(rows[0])
    if mode == "full":
        for j in range(m):
            for k in range(j, m):
                rows.append(view_sum(a_terms[(j, k)]) if (j, k) in a_terms else zero)
    if mode in ("full", "grad"):
        rows.extend(view_sum(g_terms[j]) for j in range(m))
    return torch.stack(rows)


def _check_joint(base_model: str, mode: str) -> None:
    if base_model not in JOINT_MODELS:
        raise ValueError(f"the joint kernel takes a (kd, ks, shape) base lobe "
                         f"{JOINT_MODELS}, got {base_model!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {tuple(MODES)}")


def joint_ne_rows_cuda(base_model: str, mode: str, lv, y, w, p_rows, frame) -> torch.Tensor:
    """Launch K7 on views-major CUDA inputs → the ``(R, T)`` rows."""
    _check_joint(base_model, mode)
    _build.check_operands("K7", lv, y, w, p_rows, frame)
    if lv.ndim != 3 or lv.shape[0] != 6:
        raise ValueError(f"K7: lv is (6, V, T), got {tuple(lv.shape)}")
    _, v, t = lv.shape
    if (y.shape != (3, v, t) or w.shape != (3, v, t) or p_rows.shape != (JOINT_M, t)
            or frame.shape != (9, t)):
        raise ValueError(f"K7 shapes: lv {tuple(lv.shape)}, y {tuple(y.shape)}, w {tuple(w.shape)}, "
                         f"p {tuple(p_rows.shape)}, frame {tuple(frame.shape)}")
    if t >= 2**31:
        raise ValueError(f"K7 covers fewer than 2^31 texels a launch, got T={t}")
    out = torch.empty((ne_rows_count(JOINT_M, mode), t), dtype=torch.float32, device=lv.device)
    if t == 0:
        return out
    if v == 0:
        return out.zero_()
    warps = _checked_layout("K7", "joint_ne", JOINT_M, mode, v)
    _build.launch(_JOINT, lv.device, SHADING_KERNELS[base_model].lobe_id, MODES[mode], warps,
                  lv.data_ptr(), y.data_ptr(), w.data_ptr(), p_rows.data_ptr(), frame.data_ptr(),
                  out.data_ptr(), t, v)
    LAUNCHES["joint_ne"] += 1
    return out


def joint_ne_rows(base_model: str, mode: str, lv, y, w, p_rows, frame) -> torch.Tensor:
    """K7 for CUDA tensors, its plain version for CPU tensors."""
    if _build.on_cuda(lv, "the normal-equation kernels run"):
        return joint_ne_rows_cuda(base_model, mode, lv, y, w, p_rows, frame)
    _check_joint(base_model, mode)
    return joint_ne_rows_plain(base_model, mode, lv, y, w, p_rows, frame)


# ---------------------------------------------------------------------------
# The LM control loop both kernels are driven by
# ---------------------------------------------------------------------------


def _clip_rows(p_rows: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    return torch.stack([torch.clamp(p_rows[j], cfg.lower[j], cfg.upper[j])
                        for j in range(p_rows.shape[0])])


def _split_full(out: torch.Tensor, m: int):
    a = {}
    idx = 1
    for j in range(m):
        for k in range(j, m):
            a[(j, k)] = out[idx]
            idx += 1
    return a, [out[idx + j] for j in range(m)]


def _psum(terms, zero):
    """A sum over parameters, from 0 upward (the kernels' order)."""
    acc = zero
    for x in terms:
        acc = acc + x
    return acc


def lm_step_propose_plain(cfg: LMConfig, full, p, state, pn, scratch, active) -> None:
    """``lm_step_propose_kernel``'s plain version, the first half of a pass:
    from the ``full`` rows at ``p (m, T)`` and the lane state ``(6, T)``
    (:data:`STATE_ROWS`), the projected-gradient norm, the Kanzow μ where no
    (warm) μ came in, the active-set freeze, the damped solve, the box
    projection and the predicted reduction. Writes the trial point into ``pn
    (m, T)`` and :data:`SCRATCH_ROWS` into ``scratch (6, T)``, and zeroes the
    ``active`` count."""
    m = p.shape[0]
    lb, ub = cfg.lower, cfg.upper
    a, g = _split_full(full, m)
    pr = [p[j] for j in range(m)]
    mu, it = state[1], state[3]
    zero = torch.zeros_like(mu)
    one = zero + 1.0

    pg = [torch.abs(pr[j] - torch.clamp(pr[j] - g[j], lb[j], ub[j])) for j in range(m)]
    gi = functools.reduce(torch.maximum, pg)
    grad_conv = gi <= cfg.eps1

    # Kanzow μ only when no (warm) μ was carried in
    max_diag = functools.reduce(torch.maximum, [a[(j, j)] for j in range(m)])
    mu_it = torch.where((it == 0.0) & (mu <= 0.0), cfg.tau * max_diag, mu)

    frozen = [((pr[j] <= lb[j]) & (g[j] > 0)) | ((pr[j] >= ub[j]) & (g[j] < 0))
              for j in range(m)]
    free = [torch.where(frozen[j], zero, one) for j in range(m)]
    af = {}
    for j in range(m):
        af[(j, j)] = torch.where(frozen[j], one, a[(j, j)] + mu_it)
    for j in range(m):
        for k in range(j + 1, m):
            af[(j, k)] = a[(j, k)] * free[j] * free[k]
    gf = [g[j] * free[j] for j in range(m)]

    dp, solver_ok = _solve_damped(af, gf, m)

    pt = [torch.clamp(pr[j] + dp[j], lb[j], ub[j]) for j in range(m)]
    dpa = [pt[j] - pr[j] for j in range(m)]           # the projected step
    small_dp = _psum((x * x for x in dpa), zero) <= cfg.eps2_sq * _psum((x * x for x in pr), zero)

    # predicted reduction −(2 gᵀδ + δᵀ JᵀJ δ) with the unfrozen system
    q = [_psum((a[(min(j, k), max(j, k))] * dpa[k] for k in range(m)), zero) for j in range(m)]
    g_dot = _psum((g[j] * dpa[j] for j in range(m)), zero)
    q_dot = _psum((dpa[j] * q[j] for j in range(m)), zero)
    dl = -(2.0 * g_dot + q_dot)

    pn.copy_(torch.stack(pt))
    scratch.copy_(torch.stack([mu_it, gi, dl, *(x.to(zero.dtype) for x in (solver_ok, small_dp,
                                                                           grad_conv))]))
    active.zero_()


def lm_step_accept_plain(cfg: LMConfig, chi2_new, scratch, pn, p, state, active) -> None:
    """``lm_step_accept_kernel``'s plain version, the second half of a pass:
    from χ² at the trial point ``chi2_new (T,)`` and the proposal's scratch,
    the accept, ρ, Nielsen's μ/ν and the stop codes (later assignments win).
    A lane active at the pass's start takes the update, in place in ``p`` and
    ``state``; a lane that has stopped keeps its state. ``active`` ← the lanes
    still active."""
    chi2, mu, nu, it, stop, g_inf = state
    mu_it, gi, dl = scratch[0], scratch[1], scratch[2]
    solver_ok, small_dp, grad_conv = (scratch[k] != 0.0 for k in (3, 4, 5))
    zero = torch.zeros_like(chi2)
    one = zero + 1.0
    third = zero + 1.0 / 3.0
    tiny = zero + _TINY
    act = (stop == 0.0) & (it < float(cfg.itmax))

    finite = torch.isfinite(chi2_new)
    df = chi2 - chi2_new
    accept = solver_ok & finite & (df > 0)
    rho = torch.where(dl > 0, df / torch.maximum(dl, tiny), one)
    tmp = 2.0 * rho - 1.0
    mu_next = torch.where(accept, mu_it * torch.maximum(third, 1.0 - tmp * tmp * tmp), mu_it * nu)
    nu_next = torch.where(accept, zero + 2.0, nu * 2.0)

    st = zero
    st = torch.where(mu_next > cfg.mu_max, zero + float(StopReason.NO_REDUCTION), st)
    st = torch.where((~solver_ok) & (mu_it > cfg.half_mu_max), zero + float(StopReason.SINGULAR), st)
    st = torch.where(small_dp & solver_ok, zero + float(StopReason.SMALL_DP), st)
    chi2_sel = torch.where(accept, chi2_new, chi2)
    st = torch.where(chi2_sel <= cfg.eps3, zero + float(StopReason.SMALL_CHI2), st)
    st = torch.where(grad_conv, zero + float(StopReason.SMALL_GRADIENT), st)

    p.copy_(torch.where(act & accept, pn, p))
    state.copy_(torch.stack([torch.where(act, x_new, x) for x_new, x in (
        (chi2_sel, chi2), (mu_next, mu), (nu_next, nu), (it + 1.0, it), (st, stop), (gi, g_inf))]))
    still = (state[4] == 0.0) & (state[3] < float(cfg.itmax))
    active.copy_(still.sum(dtype=torch.int32).reshape(1))


_STEP_ARGS = (_I,) + (_P,) * 6 + (_I, _P, _P) + (_F,) * 6 + (_I, _P)
_PROPOSE = _build.Entry("lm_step_propose", "lm_step", "brdf_lm_step_propose", _STEP_ARGS)
_ACCEPT = _build.Entry("lm_step_accept", "lm_step", "brdf_lm_step_accept", _STEP_ARGS)


def _check_count(name: str, active: torch.Tensor, device) -> None:
    if (not active.is_cuda or active.dtype != torch.int32 or active.shape != (1,)
            or active.device != device):
        raise ValueError(f"{name}'s active count is an int32 CUDA tensor of 1 on the lanes' device")


def _step_dims(name: str, cfg: LMConfig, p) -> tuple[int, int]:
    """``(m, T)`` of the parameter rows ``p``, for an m the step kernels are
    built for and a box of m entries."""
    if p.ndim != 2 or p.shape[0] not in STEP_PARAMS:
        raise ValueError(f"{name} is built for m in {STEP_PARAMS} parameter rows, "
                         f"got p {tuple(p.shape)}")
    m, t = p.shape
    if len(cfg.lower) != m or len(cfg.upper) != m:
        raise ValueError(f"{name}: {m} parameter rows, bounds {cfg.lower}/{cfg.upper}")
    if t >= 2**31:
        raise ValueError(f"{name} covers fewer than 2^31 lanes a launch, got T={t}")
    return m, t


def _step_cuda(entry: _build.Entry, cfg: LMConfig, active, operands) -> None:
    """Check and launch the step kernel ``entry`` on the ``(tensor, shape)``
    pairs ``operands``, in the entry's order."""
    name = entry.kernel
    _build.check_operands(name, *(x for x, _ in operands))
    device = operands[0][0].device
    _check_count(name, active, device)
    if any(tuple(x.shape) != shape for x, shape in operands):
        raise ValueError(f"{name} shapes: got {[tuple(x.shape) for x, _ in operands]}, "
                         f"want {[shape for _, shape in operands]}")
    m, t = len(cfg.lower), operands[0][1][-1]
    if t == 0:
        if entry is _PROPOSE:
            active.zero_()
        return
    lower = (ctypes.c_float * m)(*cfg.lower)
    upper = (ctypes.c_float * m)(*cfg.upper)
    _build.launch(entry, device, m, *(x.data_ptr() for x, _ in operands), active.data_ptr(), t,
                  lower, upper, cfg.eps1, cfg.eps2_sq, cfg.eps3, cfg.mu_max, cfg.half_mu_max,
                  cfg.tau, cfg.itmax)
    LAUNCHES["lm_step"] += 1


def lm_step_propose_cuda(cfg: LMConfig, full, p, state, pn, scratch, active) -> None:
    """Launch ``lm_step_propose_kernel`` on CUDA tensors: the arguments of
    :func:`lm_step_propose_plain`."""
    m, t = _step_dims("lm_step_propose", cfg, p)
    _step_cuda(_PROPOSE, cfg, active, (
        (full, (ne_rows_count(m, "full"), t)), (p, (m, t)), (state, (len(STATE_ROWS), t)),
        (pn, (m, t)), (scratch, (len(SCRATCH_ROWS), t))))


def lm_step_accept_cuda(cfg: LMConfig, chi2_new, scratch, pn, p, state, active) -> None:
    """Launch ``lm_step_accept_kernel`` on CUDA tensors: the arguments of
    :func:`lm_step_accept_plain`."""
    m, t = _step_dims("lm_step_accept", cfg, p)
    _step_cuda(_ACCEPT, cfg, active, (
        (chi2_new, (t,)), (scratch, (len(SCRATCH_ROWS), t)), (pn, (m, t)), (p, (m, t)),
        (state, (len(STATE_ROWS), t))))


def lm_step_propose(cfg: LMConfig, full, p, state, pn, scratch, active) -> None:
    """The step kernel for CUDA tensors, its plain version for CPU tensors."""
    step = (lm_step_propose_cuda if _build.on_cuda(p, "the LM step kernels run")
            else lm_step_propose_plain)
    step(cfg, full, p, state, pn, scratch, active)


def lm_step_accept(cfg: LMConfig, chi2_new, scratch, pn, p, state, active) -> None:
    """The step kernel for CUDA tensors, its plain version for CPU tensors."""
    step = (lm_step_accept_cuda if _build.on_cuda(p, "the LM step kernels run")
            else lm_step_accept_plain)
    step(cfg, chi2_new, scratch, pn, p, state, active)


def chunked_lm_loop(cfg: LMConfig, rows_fn, p_init: torch.Tensor, warm=None) -> PallasFitResult:
    """The LM control loop of the chunked tier on ``(T,)`` lanes.

    ``rows_fn(mode, p_rows (m, T)) -> (R, T)`` evaluates the normal equations
    (``"full"``) or χ² alone (``"chi2"``); ``p_init (m, T)`` is projected onto
    the box first. One pass is four launches: the normal equations at the
    current point, :func:`lm_step_propose` (projected-gradient norm, Kanzow μ
    when no warm μ came in, active-set freeze, the damped solve, box
    projection, predicted reduction), χ² at the trial point and
    :func:`lm_step_accept` (Nielsen's μ/ν and the stop codes, later
    assignments winning). A lane that has stopped keeps its state. The
    damping is additive (``opts.damping`` is not read, as in the reference).
    The lane state lives in one ``(6, T)`` tensor for the whole solve. The
    loop ends when no lane is active, which costs one host synchronisation
    per pass (the step's active count).

    With recording on (``utils/profiling.py``) the call is an ``lm.solve``
    span and each pass an ``lm.pass`` span, from its first launch to the
    activity test that ends it (the host synchronisation that waits for the
    pass); at the end the counters ``lm.lanes`` and ``lm.active_lanes`` add
    T for every pass and the lanes active in each, which is the sum of the
    lanes' iterations (one read of the device)."""
    with span("lm.solve"):
        return _lm_loop(cfg, rows_fn, p_init, warm)


def _any_active(active: torch.Tensor) -> bool:
    """Whether any lane is active, from the ``(1,)`` count: the loop's one
    host synchronisation a pass."""
    global LOOP_SYNCS
    LOOP_SYNCS += 1
    return bool(active.item())


def _lm_loop(cfg: LMConfig, rows_fn, p_init: torch.Tensor, warm, steps=None) -> PallasFitResult:
    # ``steps`` replaces (lm_step_propose, lm_step_accept), for a test that
    # runs the plain step functions on the card; no public function sets it
    propose, accept = steps or (lm_step_propose, lm_step_accept)
    p = _clip_rows(p_init, cfg)
    chi2 = rows_fn("chi2", p)[0]
    zero = torch.zeros_like(chi2)

    if warm is None:
        mu, nu, stop_w = zero, zero + 2.0, zero
    else:
        mu_w, nu_w, stop_w = (torch.as_tensor(x, device=chi2.device).to(torch.float32) for x in warm)
        mu = torch.where(torch.isfinite(mu_w) & (mu_w > 0), mu_w, zero)
        nu = torch.where(torch.isfinite(nu_w) & (nu_w >= 2.0), nu_w, zero + 2.0)
    stop0 = torch.where(torch.isfinite(chi2), zero, zero + float(StopReason.INVALID_VALUES))
    stop = torch.where(stop_w != 0.0, stop_w, stop0)
    # the solve's lane state (STATE_ROWS), the trial point and the scratch,
    # updated in place by every pass
    state = torch.stack([chi2, mu, nu, zero, stop, zero + 3.4e38])
    pn = torch.empty_like(p)
    scratch = torch.empty_like(state)
    active = ((state[4] == 0.0) & (state[3] < float(cfg.itmax))).sum(dtype=torch.int32).reshape(1)

    more = _any_active(active)
    passes = 0
    while more:
        passes += 1
        with span("lm.pass"):
            propose(cfg, rows_fn("full", p), p, state, pn, scratch, active)
            accept(cfg, rows_fn("chi2", pn)[0], scratch, pn, p, state, active)
            more = _any_active(active)

    chi2, mu, nu, it, stop, g_inf = state
    if profiling.enabled():
        # a pass adds one iteration to each lane active in it
        profiling.count("lm.lanes", passes * it.numel())
        profiling.count("lm.active_lanes", int(it.sum(dtype=torch.float64)))
    stop_out = torch.where(stop == 0.0, zero + float(StopReason.MAX_ITERATIONS), stop)
    return PallasFitResult(p=p.T.contiguous(), chi2=chi2, iters=it, stop=stop_out.to(torch.int32),
                           g_inf=g_inf, mu=mu, nu=nu)


def _views_major(x: torch.Tensor) -> torch.Tensor:
    """(T, V) → (V, T), contiguous float32."""
    return x.to(torch.float32).T.contiguous()


def _stack_lobe(model: str, angles: ShadingAngles, target, weights):
    spec = PALLAS_MODELS[model]
    chans = [getattr(angles, name) for name in spec.angle_names]
    missing = [name for name, c in zip(spec.angle_names, chans) if c is None]
    if missing:
        raise ValueError(f"{model} reads the angle channels {missing}, which are not filled "
                         "(build the angles with tangent_frame=True)")
    ang = torch.stack([c.to(torch.float32).T for c in chans]).contiguous()
    return ang, _views_major(target), None if weights is None else _views_major(weights)


def lm_fit_chunked(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,              # (T, V)
    p0: torch.Tensor,                  # (T, m)
    weights: torch.Tensor | None = None,
    opts: LMOptions = _DEFAULT_OPTS,
    lower: tuple = (0.0, 0.0, 0.0),
    upper: tuple = (100.0, 100.0, 100.0),
    axis_name: str | None = None,
    warm: tuple | None = None,
) -> PallasFitResult:
    """The LM fit of ``ops/lm.py::lm_fit_fused`` for any view count: the same
    stop codes and the same one-solve-per-iteration variant, with the normal
    equations accumulated by K6 (two launches per iteration) and the control
    loop in eager PyTorch. The contract of ``lm_fit_pallas_chunked`` without
    ``block_t``, ``view_block``, ``overlap_slices`` and ``interpret`` (the
    module docstring says why); ``weights=None`` takes the kernel variant that
    reads no weights. ``axis_name`` sums the rows over the ranks of that axis
    of the current mesh, each rank holding its own views."""
    cfg = config(model, opts, lower, upper)
    ang, y, w = _stack_lobe(model, angles, target, weights)
    p_rows = p0.to(torch.float32).T.contiguous()
    return chunked_lm_loop(
        cfg, lambda mode, pr: axis_sum(ne_rows(model, mode, ang, y, w, pr), axis_name), p_rows,
        warm)


def shading_value_and_grad(
    model: str,
    params: torch.Tensor,      # (T, m)
    angles: ShadingAngles,     # channels (T, V)
    target: torch.Tensor,      # (T, V)
    weights: torch.Tensor | None = None,
):
    """Per-texel data-fit loss and its parameter gradient in one pass over the
    angle data: ``(chi2 (T,), g (T, m))`` with ``chi2 = Σ_v (w·(I−y))²`` and
    ``g = ∂(χ²/2)/∂params`` (K6 in ``"grad"`` mode; the contract of
    ``shading_value_and_grad_pallas``). ``weights=None`` always takes the
    unweighted variant, since nothing is padded here."""
    spec = PALLAS_MODELS[model]
    ang, y, w = _stack_lobe(model, angles, target, weights)
    out = ne_rows(model, "grad", ang, y, w, params.to(torch.float32).T.contiguous())
    return out[0], out[1:1 + spec.n_params].T


def normal_equations(
    model: str,
    params: torch.Tensor,      # (T, m)
    angles: ShadingAngles,     # channels (T, V)
    target: torch.Tensor,      # (T, V)
    weights: torch.Tensor | None = None,
):
    """Per-texel χ² and Gauss-Newton matrix at ``params``: ``(chi2 (T,),
    JtJ (T, m, m))`` with the residual ``(I − y)·w`` and the lobe's analytic
    Jacobian (K6 in ``"full"`` mode, its packed upper triangle unfolded)."""
    m = PALLAS_MODELS[model].n_params
    ang, y, w = _stack_lobe(model, angles, target, weights)
    out = ne_rows(model, "full", ang, y, w, params.to(torch.float32).T.contiguous())
    upper, _ = _split_full(out, m)
    jtj = torch.stack([torch.stack([upper[(min(j, k), max(j, k))] for k in range(m)], -1)
                       for j in range(m)], -2)
    return out[0], jtj


def _joint_prep(geom: ShadingGeometry, target: torch.Tensor, weights):
    """Views-major stacks for K7: ``lv (6, V, T)``, ``y``/``w (3, V, T)`` and the
    frame ``(9, T)``. A ``(T, V)`` weight is shared by the three channels."""
    f32 = torch.float32

    def vec(x):    # (T, V, 3) → (3, V, T)
        return x.to(f32).permute(2, 1, 0)

    lv = torch.cat([vec(geom.l), vec(geom.v)]).contiguous()
    y = vec(target).contiguous()
    if weights is None:
        weights = torch.ones(target.shape[:2], dtype=f32, device=target.device)
    if weights.ndim == 2:
        weights = weights[..., None].expand(*weights.shape, 3)
    w = vec(weights).contiguous()
    n = geom.n.to(f32)
    tb, bb = tangent_basis(n)
    frame = torch.cat([n.T, tb.T, bb.T]).contiguous()
    return lv, y, w, frame


def lm_fit_joint_chunked(
    base_model: str,
    geom: ShadingGeometry,             # n (T, 3), l/v (T, V, 3)
    target: torch.Tensor,              # (T, V, 3)
    p0: torch.Tensor,                  # (T, 9)
    weights: torch.Tensor | None = None,   # (T, V) or per channel (T, V, 3)
    opts: LMOptions = JOINT_OPTS,
    lower: tuple = (),
    upper: tuple = (),
    axis_name: str | None = None,
    warm: tuple | None = None,
) -> PallasFitResult:
    """The m = 9 joint normal-map fit: the control loop of
    :func:`lm_fit_chunked` around K7, which evaluates the cosines and their
    offset partials from the geometry, so an iteration is two passes over the
    (L, V, y, w) stacks and nothing of size V·T is written. The contract of
    ``lm_fit_joint_pallas_chunked`` without ``block_t``, ``view_block`` and
    ``interpret``; ``axis_name`` as in :func:`lm_fit_chunked`."""
    if len(lower) != JOINT_M or len(upper) != JOINT_M:
        raise ValueError(f"joint fit has {JOINT_M} params; got bounds {lower}/{upper}")
    _check_joint(base_model, "full")
    cfg = solve_config(base_model, opts, lower, upper)
    lv, y, w, frame = _joint_prep(geom, target, weights)
    p_rows = p0.to(torch.float32).T.contiguous()
    return chunked_lm_loop(
        cfg, lambda mode, pr: axis_sum(joint_ne_rows(base_model, mode, lv, y, w, pr, frame),
                                       axis_name), p_rows, warm)


def joint_value_and_grad(
    base_model: str,
    params: torch.Tensor,      # (T, 9)
    geom: ShadingGeometry,
    target: torch.Tensor,      # (T, V, 3)
    weights: torch.Tensor | None = None,
):
    """Loss and gradient of the joint model through the angles in one pass:
    ``(chi2 (T,), g (T, 9))`` with ``g = ∂(χ²/2)/∂params`` including the two
    normal-offset columns (K7 in ``"grad"`` mode; the contract of
    ``joint_value_and_grad_pallas``)."""
    lv, y, w, frame = _joint_prep(geom, target, weights)
    out = joint_ne_rows(base_model, "grad", lv, y, w,
                        params.to(torch.float32).T.contiguous(), frame)
    return out[0], out[1:1 + JOINT_M].T
