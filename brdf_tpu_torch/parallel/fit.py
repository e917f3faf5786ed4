"""Per-texel BRDF fitting: init → fit → IRLS rounds, on one device or over
a ``(data, view)`` mesh of ranks.

Port of ``brdf_tpu/parallel/fit.py``'s ``fit_texels_sharded`` and
``_fit_pipeline_program``. The JAX package traces the whole pipeline into
one program over a device mesh; here PyTorch runs it eagerly, one rank a
device (``parallel/mesh.py``), and the kernels are the only device work of
any weight. :func:`fit_texels` is the fit of one device, the 1 × 1 mesh;
:func:`fit_texels_sharded` takes the rank's own ``(T_local, V_local)`` block
and returns its own block, as the JAX package does on a multi-process
runtime.

Engines, under the JAX package's names so that its presets carry over:

- ``"pallas"`` — the hand-written LM tiers, any of the ten lobes: the fused
  solve of ``ops/lm.py`` (kernel K5, ``csrc/lm.cu``) while a block of it can
  stage the views in shared memory (``ops/lm.py::fits_fused``: V ≤ 165 for a
  nine-channel lobe, V ≤ 454 for blinn_phong), else the chunked tier of
  ``ops/ne.py`` (kernel K6, ``csrc/ne.cu``, under an eager LM loop), which
  takes any view count. On the CPU their plain versions run, as the JAX
  package runs its kernels in interpret mode there.
- ``"xla"`` — the eager PyTorch tier, ``solver/lm.py::levmar_bc``. Any lobe.
- ``"varpro"`` — variable projection, for every separable lobe: the fused
  1-D tier ``ops/varpro.py`` (kernel K1) for the four m=3 lobes, the fused
  d-D tier ``ops/varpro_nd.py`` (kernel K8) for ``ward_aniso`` and
  ``cook_torrance_aniso``, and the eager scale-profiled
  ``solver/varpro.py::varpro_fit_fresnel_lin`` for
  ``cook_torrance_fresnel`` (it has no kernel in either package). On the
  CPU K1 and K8 run their plain versions.
- ``"auto"`` — ``"pallas"`` on a CUDA device, ``"xla"`` on the CPU.

A mesh routes as ``_make_fit_block`` does. With unsharded views (view axis
of size 1) every rank runs the tiers above on its texels alone. With
sharded views a fused kernel cannot see a texel's other views, so the LM
engines take the chunked tier (K6, rows summed over the view axis) or the
eager ``levmar_bc``, and VarPro the eager ``solver/varpro.py`` fits, all
with ``axis_name="view"``; the grid init and the robust scale see every
view through the same sums. After each sum the replicas of a view group
hold the same bits, so they take the same path through every loop.

Every fit of ``pipeline/fit.py`` runs by the rules written once here: the
engine rule (:func:`_resolve_engine`), the IRLS rounds (:func:`irls`), the
mapping of a kernel tier's or a VarPro tier's result onto the LM result
(:func:`lm_result`, :func:`varpro_result`) and the per-texel fit's default
options (:data:`FIT_OPTS`).
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.ops.lm import PALLAS_MODELS, fits_fused, lm_fit_fused
from brdf_tpu_torch.ops.ne import lm_fit_chunked
from brdf_tpu_torch.ops.varpro import varpro_fit_fused
from brdf_tpu_torch.ops.varpro_nd import varpro_fit_fused_nd
from brdf_tpu_torch.parallel.mesh import VIEW_AXIS, Mesh, use_mesh
from brdf_tpu_torch.solver.init import linear_grid_init
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, levmar_bc
from brdf_tpu_torch.solver.robust import robust_weights
from brdf_tpu_torch.solver.varpro import (
    _SEPARABLE,
    _SEPARABLE_ND,
    varpro_fit,
    varpro_fit_fresnel_lin,
    varpro_fit_nd,
)
from brdf_tpu_torch.utils.profiling import span

ENGINES = ("auto", "pallas", "xla", "varpro")
# The per-texel fit's solver options where the caller gives none; the joint
# fit's are ops/ne.py::JOINT_OPTS, its kernel tier's default.
FIT_OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=60)


def _resolve_engine(engine: str, device_type: str, kernel_tier: bool) -> str:
    """``engine`` checked against :data:`ENGINES`. ``"auto"`` keys off the
    device the fit runs on: ``"pallas"`` on CUDA where a kernel tier takes
    the fit (``kernel_tier``), else ``"xla"``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if engine != "auto":
        return engine
    return "pallas" if device_type == "cuda" and kernel_tier else "xla"


def irls(first, reweight, refit, rounds: int):
    """Round 0 (``first()``), then ``rounds`` IRLS rounds: round ``i`` takes
    its weights from round ``i − 1``'s result ``r`` (``reweight(r)``) and
    refits under them (``refit(w, r)``). Each round's solve is a
    ``fit.solve`` span and each reweighting a ``fit.reweight`` span, both
    carrying the round."""
    with span("fit.solve", round=0):
        res = first()
    for rnd in range(1, rounds + 1):
        with span("fit.reweight", round=rnd):
            w = reweight(res)
        with span("fit.solve", round=rnd):
            res = refit(w, res)
        del w       # freed before the next round's weights are made
    return res


def lm_result(r) -> LMResult:
    """A kernel tier's result (``ops/lm.py::PallasFitResult``) as an LM
    result: an iteration is one Jacobian pass, one solve and one trial
    evaluation."""
    z = torch.zeros_like(r.chi2)
    iters = r.iters.to(torch.int32)
    return LMResult(
        p=r.p, chi2=r.chi2, chi2_init=z, g_inf=r.g_inf, iters=iters, stop=r.stop,
        nfev=(2.0 * r.iters + 1).to(torch.int32), njev=iters, mu=r.mu, nu=r.nu,
        nlss=iters, constraint_violation=z,
    )


def varpro_result(r, k: int) -> LMResult:
    """A VarPro result of ``k`` steps (``VarProResult`` or
    ``JointVarProResult``: p, χ², iterations, stop, gradient) as an LM
    result: every iteration evaluates once whether accepted or not, so the
    work counters report the fixed schedule (k+1 evaluations, k
    closed-form solves)."""
    p, chi2, iters, stop, grad = r
    z = torch.zeros_like(chi2)
    k_full = torch.full_like(iters, k)
    return LMResult(
        p=p, chi2=chi2, chi2_init=z, g_inf=grad, iters=iters, stop=stop,
        nfev=k_full + 1, njev=k_full, mu=z, nu=z, nlss=k_full, constraint_violation=z,
    )


def _fit_varpro(model, angles, target, weights, p0, k, lower, upper) -> LMResult:
    """One VarPro fit by the fused tier of its lobe (views unsharded)."""
    if model == "cook_torrance_fresnel":
        r = varpro_fit_fresnel_lin(angles, target, weights=weights, p0=p0, iters=k,
                                   lower=lower, upper=upper)
    else:
        fused = varpro_fit_fused_nd if model in _SEPARABLE_ND else varpro_fit_fused
        r = fused(model, angles, target, weights=weights, p0=p0, iters=k,
                  lower=lower, upper=upper)
    return varpro_result(r, k)


def _fit_varpro_views(model, angles, target, weights, p0, k, lower, upper) -> LMResult:
    """One VarPro fit over sharded views: the eager tier of its lobe with its
    view sums across the view axis (``_make_fit_block``'s XLA tiers)."""
    kw = dict(weights=weights, p0=p0, iters=k, lower=lower, upper=upper, axis_name=VIEW_AXIS)
    if model == "cook_torrance_fresnel":
        r = varpro_fit_fresnel_lin(angles, target, **kw)
    elif model in _SEPARABLE_ND:
        r = varpro_fit_nd(model, angles, target, **kw)
    else:
        r = varpro_fit(model, angles, target, **kw)
    return varpro_result(r, k)


def _fit_fused_lm(model, angles, target, weights, p0, warm, opts, lower, upper,
                  axis_name=None) -> LMResult:
    """One LM fit by the hand-written tiers mapped onto the LM result: the
    fused kernel (K5) while it can stage the views and the view axis is not
    sharded, else the chunked tier (K6), both with the warm state carried."""
    warm_f = (warm[0], warm[1], warm[2].to(torch.float32))
    kw = dict(weights=weights, opts=opts._replace(axis_name=None), lower=lower, upper=upper,
              warm=warm_f)
    if axis_name is None and fits_fused(len(PALLAS_MODELS[model].angle_names), target.shape[1]):
        return lm_result(lm_fit_fused(model, angles, target, p0, **kw))
    return lm_result(lm_fit_chunked(model, angles, target, p0, axis_name=axis_name, **kw))


def _fit_eager_lm(model, angles, target, weights, p0, warm, opts, lower, upper,
                  axis_name=None) -> LMResult:
    spec = MODELS[model]

    def residual(p, data):
        ang, y, w = data
        return (spec.fn(p, ang) - y) * w

    return levmar_bc(residual, p0, lower, upper, data=(angles, target, weights),
                     opts=opts._replace(axis_name=axis_name), warm_state=warm)


def _fit_pipeline(model, angles, target, opts, p0, weights, lower, upper, engine, warm_state,
                  robust, robust_iters, dev, view_axis) -> LMResult:
    """The pipeline of :func:`fit_texels` on ``dev``, with the view axis
    sharded over ``view_axis`` of the current mesh when it is not None."""
    engine = _resolve_engine(engine, dev.type, model in PALLAS_MODELS)
    if engine == "varpro" and model not in _SEPARABLE and model not in _SEPARABLE_ND:
        raise ValueError(
            f"the varpro engine supports the separable lobes "
            f"{sorted(_SEPARABLE) + sorted(_SEPARABLE_ND)}, got {model!r}")
    spec = MODELS[model]
    if opts is None:
        opts = FIT_OPTS
    lower_t = tuple(float(x) for x in np.ravel(np.asarray(spec.lower if lower is None else lower)))
    upper_t = tuple(float(x) for x in np.ravel(np.asarray(spec.upper if upper is None else upper)))
    angles = ShadingAngles(*(None if a is None else a.to(dev) for a in angles))
    target = target.to(dev)
    weights = torch.ones_like(target) if weights is None else weights.to(dev, target.dtype)
    if p0 is not None:
        p0 = p0.to(dev)
    rounds = robust_iters if robust is not None else 0

    def reweight(res):
        return robust_weights(spec.fn(res.p, angles) - target, weights, kind=robust,
                              axis_name=view_axis)

    if engine == "varpro":
        k = min(opts.itmax, 16)
        if view_axis is None:
            return irls(
                lambda: _fit_varpro(model, angles, target, weights, p0, k, lower_t, upper_t),
                reweight,
                lambda w, r: _fit_varpro(model, angles, target, w,
                                         r.p if p0 is not None else None, k, lower_t, upper_t),
                rounds)
        # the eager tiers start from the grid init over every view, as the
        # JAX package's do; the Fresnel lobe's keeps its own roughness grid
        own_grid = p0 is None and model == "cook_torrance_fresnel"
        if p0 is None and not own_grid:
            p0 = linear_grid_init(model, angles, target, weights=weights, axis_name=view_axis)
        return irls(
            lambda: _fit_varpro_views(model, angles, target, weights, p0, k, lower_t, upper_t),
            reweight,
            lambda w, r: _fit_varpro_views(model, angles, target, w, None if own_grid else r.p,
                                           k, lower_t, upper_t),
            rounds)

    fit = _fit_fused_lm if engine == "pallas" else _fit_eager_lm
    t = target.shape[0]
    warm0 = (
        torch.zeros(t, dtype=target.dtype, device=dev),
        torch.full((t,), 2.0, dtype=target.dtype, device=dev),
        torch.zeros(t, dtype=torch.int32, device=dev),
    )
    warm = warm0 if warm_state is None else tuple(
        torch.as_tensor(x).to(dev) for x in warm_state)
    if p0 is None:
        p0 = linear_grid_init(model, angles, target, weights=weights, axis_name=view_axis)
    return irls(
        lambda: fit(model, angles, target, weights, p0, warm, opts, lower_t, upper_t, view_axis),
        reweight,
        lambda w, r: fit(model, angles, target, w, r.p, warm0, opts, lower_t, upper_t,
                         view_axis),
        rounds)


def fit_texels(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,
    opts: LMOptions | None = None,
    p0: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    lower=None,
    upper=None,
    engine: str = "auto",
    warm_state=None,
    robust: str | None = None,
    robust_iters: int = 0,
    device=None,
) -> LMResult:
    """Fit per-texel BRDF parameters on one device.

    Args:
      model: registered model name.
      angles/target: (T, V) cosines and measured intensities.
      opts: solver options; the VarPro step count is ``min(opts.itmax, 16)``.
      p0: optional (T, m) start. The LM engines run the linear grid init
        once, before round 0, when there is none. The VarPro engine instead
        re-runs its own grid init (in the kernel for K1 and K8, the roughness
        grid of ``varpro_fit_fresnel_lin``) in every round (the first and
        each IRLS round) under that round's weights; with a start, round 0
        begins from it and round ``i > 0`` from round ``i − 1``'s parameters.
      weights: optional (T, V) residual weights (0 masks a measurement).
      engine: "auto" | "pallas" | "xla" | "varpro", see the module docstring.
      warm_state: optional (μ, ν, stop) triple of (T,) tensors (e.g.
        ``prev.warm_state()``) resuming a chunked fit with ``p0=prev.p``;
        terminated lanes short-circuit. Carried by both LM engines, ignored
        by VarPro (whose whole continuation state is the start).
      robust/robust_iters: IRLS rounds ("huber"/"cauchy"/"tukey"); round
        ``i > 0`` uses ``robust_weights(fn(p_prev) − y, weights, kind)``,
        starts from round ``i − 1``'s parameters and from a cold damping
        state.
      device: where to run; ``cuda`` unless the caller passes another. The
        fused kernels run on CUDA; on the CPU their plain versions.
    """
    return _fit_pipeline(model, angles, target, opts, p0, weights, lower, upper, engine,
                         warm_state, robust, robust_iters, resolve_device(device), None)


def fit_texels_sharded(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,
    mesh: Mesh,
    opts: LMOptions | None = None,
    p0: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    lower=None,
    upper=None,
    engine: str = "auto",
    warm_state=None,
    robust: str | None = None,
    robust_iters: int = 0,
) -> LMResult:
    """Fit per-texel BRDF parameters over a ``(data, view)`` mesh of ranks.

    Every array argument is this rank's own block: ``(T_local, V_local)``
    angles, target and weights, the texels of its data coordinate and the
    views of its view coordinate, and ``(T_local, …)`` ``p0`` and
    ``warm_state``; the result is the rank's block of texels, the same on
    every rank of its view group. Every rank of the mesh must call this with
    the same arguments but the blocks. The arguments are
    :func:`fit_texels`'s, and the fit runs on ``mesh.device``; without a
    start the LM engines (and VarPro over sharded views) begin from the grid
    init over every view of the texel. A 1 × 1 mesh is :func:`fit_texels`,
    bit for bit.
    """
    with use_mesh(mesh):
        return _fit_pipeline(model, angles, target, opts, p0, weights, lower, upper, engine,
                             warm_state, robust, robust_iters, mesh.device,
                             VIEW_AXIS if mesh.view > 1 else None)
