"""Per-texel fit driver.

Port of ``brdf_tpu/pipeline/fit.py``'s ``TexelProblem``, ``FitReport`` and
``fit_per_texel``: channels fold into the texel batch, saturated
measurements are masked, one :func:`~brdf_tpu_torch.parallel.fit.fit_texels`
call runs init → fit → IRLS rounds, and the result is reshaped to
``(T, C, …)``. Not ported yet: the chunked resume (``checkpointer``,
``chunk_iters``) and the scene builders ``build_face_problem`` /
``build_pixel_problem`` (ROADMAP.md Queue A item 6), and
``FitReport.statistics`` (Queue A item 9).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.parallel.fit import fit_texels
from brdf_tpu_torch.solver.lm import LMOptions, LMResult
from brdf_tpu_torch.solver.robust import saturation_weights


class TexelProblem(NamedTuple):
    """Per-texel fit inputs: angles (T, V), intensities (T, V, C), weights (T, V)."""

    angles: ShadingAngles
    intensity: torch.Tensor
    weights: torch.Tensor
    face_ids: np.ndarray               # (T,) mesh face backing each texel
    geometry: object = None            # ShadingGeometry when built with geometry
    pixels: np.ndarray | None = None   # (T, 2) for pixel-granularity texels
    points: np.ndarray | None = None   # (T, 3) texel surface positions
    normals: np.ndarray | None = None  # (T, 3) texel shading normals


@dataclasses.dataclass
class FitReport:
    """Fitted parameters + per texel and channel solver diagnostics."""

    params: torch.Tensor      # (T, C, m)
    face_ids: np.ndarray      # (T,)
    result: LMResult          # every field (T, C), or (T, C, m) for p
    model: str

    def converged_fraction(self) -> float:
        stop = self.result.stop
        conv = (stop == 1) | (stop == 2) | (stop == 6)
        return float(conv.to(torch.float64).mean())

    def chi2_summary(self) -> dict:
        chi2 = self.result.chi2.to(torch.float64).cpu().numpy()
        return {
            "median": float(np.median(chi2)),
            "p90": float(np.percentile(chi2, 90)),
            "max": float(chi2.max()),
        }


def fit_per_texel(
    problem: TexelProblem,
    model: str = "blinn_phong",
    opts: LMOptions | None = None,
    device=None,
    engine: str = "varpro",
    mask_saturation: bool = True,
    robust: str | None = None,
    robust_iters: int = 2,
    checkpointer=None,
    chunk_iters: int = 0,
    resume: bool = True,
    lower=None,
    upper=None,
) -> FitReport:
    """Fit every (texel, channel) independently — T·C problems, batched.

    The arguments are those of the JAX ``fit_per_texel`` with ``mesh=``
    replaced by ``device=`` (``cuda`` unless the caller passes another).
    ``engine`` defaults to "varpro", the one engine ported so far (the JAX
    default "auto" raises ``NotImplementedError`` here, naming its ROADMAP
    item). ``resume`` only matters with a checkpointer.
    """
    if checkpointer is not None or chunk_iters:
        raise NotImplementedError(
            "chunked resume (checkpointer/chunk_iters) is not ported yet: "
            "ROADMAP.md Queue A item 6 (utils/checkpoint.py, _fit_chunked)"
        )
    dev = resolve_device(device)
    spec = MODELS[model]
    if spec.tangent and problem.angles.cos_th is None:
        raise NotImplementedError(
            f"model {model!r} needs tangent-frame angles, which the port builds "
            "with ROADMAP.md Queue A item 8 (models/normalmap.py)"
        )
    t, v, c = problem.intensity.shape

    # fold channels into the batch: angles/weights repeat per channel
    ang_rep = ShadingAngles(*(
        None if a is None else torch.as_tensor(a).to(dev).repeat_interleave(c, dim=0)
        for a in problem.angles
    ))
    intensity = torch.as_tensor(problem.intensity).to(dev)
    target = intensity.permute(0, 2, 1).reshape(t * c, v)
    w_rep = torch.as_tensor(problem.weights).to(dev).repeat_interleave(c, dim=0)
    if mask_saturation:
        w_rep = w_rep * saturation_weights(target)

    res = fit_texels(
        model, ang_rep, target, opts=opts, weights=w_rep, engine=engine,
        lower=lower, upper=upper, robust=robust,
        robust_iters=robust_iters if robust else 0, device=dev,
    )
    params = res.p.reshape(t, c, spec.n_params)
    result = LMResult(*(x.reshape(t, c) if x.ndim == 1 else x for x in res))
    return FitReport(params=params, face_ids=problem.face_ids, result=result, model=model)
