"""Per-texel BRDF fitting on one GPU: init → fit → IRLS rounds.

Single-device counterpart of ``brdf_tpu/parallel/fit.py``'s
``fit_texels_sharded`` and ``_fit_pipeline_program``. The JAX package
traces the whole pipeline into one program over a device mesh; here
PyTorch runs it eagerly on one device, and the fused VarPro kernel is the
only device work of any weight. The ``warm_state`` argument (the LM
engines' damping state, which VarPro ignores) comes with the LM slice, and
multi-GPU sharding after the front end (ROADMAP.md Queue A items 4 and 5).
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.ops.varpro import varpro_fit_fused
from brdf_tpu_torch.solver.lm import LMOptions, LMResult
from brdf_tpu_torch.solver.robust import robust_weights
from brdf_tpu_torch.solver.varpro import _SEPARABLE

# the VarPro branches for m ≥ 4 lobes (parallel/fit.py:81-123) wait for the
# ports of varpro_fit_fresnel_lin, varpro_fit_nd and kernel K8
_VARPRO_LATER = {
    "cook_torrance_fresnel": "ROADMAP.md Queue A item 3 (varpro_fit_fresnel_lin)",
    "ward_aniso": "ROADMAP.md Queue A item 3 (varpro_fit_nd) and Queue B item 7 (kernel K8)",
    "cook_torrance_aniso": "ROADMAP.md Queue A item 3 (varpro_fit_nd) and Queue B item 7 (kernel K8)",
}
_ENGINES_LATER = {
    "auto": "ROADMAP.md Queue B item 3 (fused LM kernel K5), which 'auto' picks on the GPU",
    "pallas": "ROADMAP.md Queue B items 3 and 5 (fused LM kernel K5, chunked kernel K6)",
    "xla": "ROADMAP.md Queue A item 4 (levmar_bc, the LM eager tier)",
}


def _fit_once(model, angles, target, weights, p0, k, lower, upper) -> LMResult:
    """One VarPro fit mapped onto the LM result: every iteration evaluates
    once whether accepted or not, so the work counters report the fixed
    schedule (k+1 evaluations, k closed-form solves)."""
    r = varpro_fit_fused(model, angles, target, weights=weights, p0=p0, iters=k,
                         lower=lower, upper=upper)
    z = torch.zeros_like(r.chi2)
    k_full = torch.full_like(r.iters, k)
    return LMResult(
        p=r.p, chi2=r.chi2, chi2_init=z, g_inf=r.g_abs, iters=r.iters, stop=r.stop,
        nfev=k_full + 1, njev=k_full, mu=z, nu=z, nlss=k_full, constraint_violation=z,
    )


def fit_texels(
    model: str,
    angles: ShadingAngles,
    target: torch.Tensor,
    opts: LMOptions | None = None,
    p0: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    lower=None,
    upper=None,
    engine: str = "varpro",
    robust: str | None = None,
    robust_iters: int = 0,
    device=None,
) -> LMResult:
    """Fit per-texel BRDF parameters on one device.

    Args:
      model: registered model name; ``engine="varpro"`` takes the four
        separable lobes (blinn_phong, phong, cook_torrance, ward).
      angles/target: (T, V) cosines and measured intensities.
      opts: solver options; the VarPro step count is ``min(opts.itmax, 16)``.
      p0: optional (T, m) start. Without one, every round (the first and
        each IRLS round) re-runs the fused solve's in-kernel grid init under
        that round's weights; with one, round 0 starts from it and round
        ``i > 0`` from round ``i − 1``'s parameters.
      weights: optional (T, V) residual weights (0 masks a measurement).
      engine: "varpro" only in this port so far; the others raise
        ``NotImplementedError`` naming the ROADMAP item that brings them.
      robust/robust_iters: IRLS rounds ("huber"/"cauchy"/"tukey"); round
        ``i > 0`` uses ``robust_weights(fn(p_prev) − y, weights, kind)``.
      device: where to run; ``cuda`` unless the caller passes another.
        The fused kernel K1 runs on CUDA; on the CPU its plain version.
    """
    if engine != "varpro":
        later = _ENGINES_LATER.get(engine, "unknown engine")
        raise NotImplementedError(f"engine={engine!r} is not ported yet: {later}")
    if model in _VARPRO_LATER:
        raise NotImplementedError(
            f"the varpro engine for {model!r} is not ported yet: {_VARPRO_LATER[model]}")
    if model not in _SEPARABLE:
        raise ValueError(
            f"varpro_fit supports separable m=3 lobes {sorted(_SEPARABLE)}, got {model!r}")
    dev = resolve_device(device)
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
    k = min(opts.itmax, 16)

    res = _fit_once(model, angles, target, weights, p0, k, lower_t, upper_t)
    if robust is None:
        return res
    for _ in range(robust_iters):
        w_irls = robust_weights(spec.fn(res.p, angles) - target, weights, kind=robust)
        res = _fit_once(model, angles, target, w_irls, res.p if p0 is not None else None,
                        k, lower_t, upper_t)
    return res
