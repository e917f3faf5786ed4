"""Per-texel BRDF fitting on one GPU: init → fit → IRLS rounds.

Single-device counterpart of ``brdf_tpu/parallel/fit.py``'s
``fit_texels_sharded`` and ``_fit_pipeline_program``. The JAX package
traces the whole pipeline into one program over a device mesh; here
PyTorch runs it eagerly on one device, and the fused kernels (K5 for the LM
engines, K1 and K8 for VarPro) are the only device work of any weight.

Engines, under the JAX package's names so that its presets carry over:

- ``"pallas"`` — the hand-written LM tiers, any of the ten lobes: the fused
  solve of ``ops/lm.py`` (kernel K5, ``csrc/lm.cu``) while a block of it can
  stage the views in shared memory (``ops/lm.py::fits_fused``: V ≤ 165 for a
  nine-channel lobe, V ≤ 454 for blinn_phong), else the chunked tier of
  ``ops/ne.py`` (kernel K6, ``csrc/ne.cu``, under an eager LM loop), which
  takes any view count. On the CPU their plain versions run, as the JAX
  package runs its kernels in interpret mode there.
- ``"xla"`` — the eager PyTorch tier, ``solver/lm.py::levmar_bc``. Any lobe.
- ``"varpro"`` — variable projection, for every separable lobe, routed as
  the JAX package routes it on one device: the fused 1-D tier
  ``ops/varpro.py`` (kernel K1) for the four m=3 lobes, the fused d-D tier
  ``ops/varpro_nd.py`` (kernel K8) for ``ward_aniso`` and
  ``cook_torrance_aniso``, and the eager scale-profiled
  ``solver/varpro.py::varpro_fit_fresnel_lin`` for
  ``cook_torrance_fresnel`` (it has no kernel in either package). On the
  CPU K1 and K8 run their plain versions.
- ``"auto"`` — ``"pallas"`` on a CUDA device, ``"xla"`` on the CPU.

Not ported yet: multi-GPU sharding (ROADMAP.md Queue A item 5, after the
front end).
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
from brdf_tpu_torch.solver.init import linear_grid_init
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, levmar_bc
from brdf_tpu_torch.solver.robust import robust_weights
from brdf_tpu_torch.solver.varpro import _SEPARABLE, _SEPARABLE_ND, varpro_fit_fresnel_lin

ENGINES = ("auto", "pallas", "xla", "varpro")


def _resolve_engine(engine: str, device_type: str, model: str) -> str:
    """``"auto"`` keys off the device the fit runs on: the fused LM tier on
    CUDA for a kernel lobe, the eager tier elsewhere."""
    if engine != "auto":
        return engine
    return "pallas" if device_type == "cuda" and model in PALLAS_MODELS else "xla"


def _fit_varpro(model, angles, target, weights, p0, k, lower, upper) -> LMResult:
    """One VarPro fit by the tier of its lobe, mapped onto the LM result:
    every iteration evaluates once whether accepted or not, so the work
    counters report the fixed schedule (k+1 evaluations, k closed-form
    solves)."""
    if model == "cook_torrance_fresnel":
        r = varpro_fit_fresnel_lin(angles, target, weights=weights, p0=p0, iters=k,
                                   lower=lower, upper=upper)
    else:
        fused = varpro_fit_fused_nd if model in _SEPARABLE_ND else varpro_fit_fused
        r = fused(model, angles, target, weights=weights, p0=p0, iters=k,
                  lower=lower, upper=upper)
    z = torch.zeros_like(r.chi2)
    k_full = torch.full_like(r.iters, k)
    return LMResult(
        p=r.p, chi2=r.chi2, chi2_init=z, g_inf=r.g_abs, iters=r.iters, stop=r.stop,
        nfev=k_full + 1, njev=k_full, mu=z, nu=z, nlss=k_full, constraint_violation=z,
    )


def _fit_fused_lm(model, angles, target, weights, p0, warm, opts, lower, upper) -> LMResult:
    """One LM fit by the hand-written tiers mapped onto the LM result: the
    fused kernel (K5) while it can stage the views, else the chunked tier
    (K6), both with the warm state carried. An iteration is one Jacobian
    pass, one solve and one trial evaluation in either."""
    warm_f = (warm[0], warm[1], warm[2].to(torch.float32))
    fused = fits_fused(len(PALLAS_MODELS[model].angle_names), target.shape[1])
    r = (lm_fit_fused if fused else lm_fit_chunked)(
        model, angles, target, p0, weights=weights,
        opts=opts._replace(axis_name=None), lower=lower, upper=upper, warm=warm_f)
    z = torch.zeros_like(r.chi2)
    iters = r.iters.to(torch.int32)
    return LMResult(
        p=r.p, chi2=r.chi2, chi2_init=z, g_inf=r.g_inf, iters=iters, stop=r.stop,
        nfev=(2.0 * r.iters + 1).to(torch.int32), njev=iters, mu=r.mu, nu=r.nu,
        nlss=iters, constraint_violation=z,
    )


def _fit_eager_lm(model, angles, target, weights, p0, warm, opts, lower, upper) -> LMResult:
    spec = MODELS[model]

    def residual(p, data):
        ang, y, w = data
        return (spec.fn(p, ang) - y) * w

    return levmar_bc(residual, p0, lower, upper, data=(angles, target, weights),
                     opts=opts._replace(axis_name=None), warm_state=warm)


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
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    dev = resolve_device(device)
    engine = _resolve_engine(engine, dev.type, model)
    if engine == "varpro" and model not in _SEPARABLE and model not in _SEPARABLE_ND:
        raise ValueError(
            f"the varpro engine supports the separable lobes "
            f"{sorted(_SEPARABLE) + sorted(_SEPARABLE_ND)}, got {model!r}")
    spec = MODELS[model]
    if opts is None:
        opts = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=60)
    lower_t = tuple(float(x) for x in np.ravel(np.asarray(spec.lower if lower is None else lower)))
    upper_t = tuple(float(x) for x in np.ravel(np.asarray(spec.upper if upper is None else upper)))
    angles = ShadingAngles(*(None if a is None else a.to(dev) for a in angles))
    target = target.to(dev)
    weights = torch.ones_like(target) if weights is None else weights.to(dev, target.dtype)
    if p0 is not None:
        p0 = p0.to(dev)

    if engine == "varpro":
        k = min(opts.itmax, 16)
        res = _fit_varpro(model, angles, target, weights, p0, k, lower_t, upper_t)
        for _ in range(robust_iters if robust is not None else 0):
            w_irls = robust_weights(spec.fn(res.p, angles) - target, weights, kind=robust)
            res = _fit_varpro(model, angles, target, w_irls, res.p if p0 is not None else None,
                              k, lower_t, upper_t)
        return res

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
        p0 = linear_grid_init(model, angles, target, weights=weights)
    res = fit(model, angles, target, weights, p0, warm, opts, lower_t, upper_t)
    for _ in range(robust_iters if robust is not None else 0):
        w_irls = robust_weights(spec.fn(res.p, angles) - target, weights, kind=robust)
        res = fit(model, angles, target, w_irls, res.p, warm0, opts, lower_t, upper_t)
    return res
