"""Per-texel fit driver.

Port of ``brdf_tpu/pipeline/fit.py``'s ``TexelProblem``, ``FitReport`` and
``fit_per_texel``: channels fold into the texel batch, saturated
measurements are masked, one :func:`~brdf_tpu_torch.parallel.fit.fit_texels`
call runs init → fit → IRLS rounds, and the result is reshaped to
``(T, C, …)``. With a checkpointer and ``chunk_iters`` the solve runs in
resumable chunks (``_fit_chunked``): the full solver state is saved between
chunks and a killed run picks up where it stopped. Not ported yet: the
scene builders ``build_face_problem`` / ``build_pixel_problem`` and
``fit_quality_metrics`` (ROADMAP.md Queue A item 6), and
``FitReport.statistics`` (Queue A item 9).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles, angles_from_geometry_np
from brdf_tpu_torch.parallel.fit import fit_texels
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, StopReason
from brdf_tpu_torch.solver.robust import robust_weights, saturation_weights
from brdf_tpu_torch.utils.checkpoint import latest_step


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


def _merge_chunk(acc: LMResult, res: LMResult, active: torch.Tensor) -> LMResult:
    """Fold one resumed chunk into the accumulated result: lanes that had
    already terminated keep their values; lanes active this chunk take the new
    ones, with iteration/evaluation counters accumulating."""
    def keep(new, old):
        return torch.where(active, new, old)

    def count(new, old):
        return old + torch.where(active, new, torch.zeros_like(new))

    return LMResult(
        p=torch.where(active[:, None], res.p, acc.p),
        chi2=keep(res.chi2, acc.chi2),
        chi2_init=acc.chi2_init,
        g_inf=keep(res.g_inf, acc.g_inf),
        iters=count(res.iters, acc.iters),
        stop=keep(res.stop, acc.stop),
        nfev=count(res.nfev, acc.nfev),
        njev=count(res.njev, acc.njev),
        mu=keep(res.mu, acc.mu),
        nu=keep(res.nu, acc.nu),
        nlss=count(res.nlss, acc.nlss),
        constraint_violation=keep(res.constraint_violation, acc.constraint_violation),
    )


def _fit_chunked(
    model, angles, target, dev, opts, weights, engine, checkpointer,
    chunk_iters, resume, lower=None, upper=None,
) -> LMResult:
    """Run the fit in chunks of ``chunk_iters`` outer iterations,
    checkpointing the full solver state (p, μ, ν, stop, counters) between
    chunks and resuming from the newest checkpoint when it fits this problem.
    Already-terminated lanes short-circuit in later chunks."""
    t = target.shape[0]
    acc: LMResult | None = None
    done = 0
    if resume and latest_step(checkpointer.path) is not None:
        arrays, meta = checkpointer.restore()
        if meta.get("model") == model and arrays["p"].shape[0] == t:
            acc = LMResult(**{k: torch.as_tensor(np.asarray(arrays[k]), device=dev)
                              for k in LMResult._fields})
            done = int(meta["iters_done"])

    while done < opts.itmax:
        if acc is None:
            p0, warm, active = None, None, torch.ones(t, dtype=torch.bool, device=dev)
        else:
            warm = acc.warm_state()
            active = warm[2] == int(StopReason.RUNNING)
            if not bool(active.any()):
                break
            p0 = acc.p
        step = min(chunk_iters, opts.itmax - done)
        res = fit_texels(
            model, angles, target, opts=opts._replace(itmax=step), weights=weights, p0=p0,
            engine=engine, warm_state=warm, lower=lower, upper=upper, device=dev,
        )
        acc = res if acc is None else _merge_chunk(acc, res, active)
        done += step
        checkpointer.maybe_save(
            done,
            {k: getattr(acc, k).detach().cpu().numpy() for k in LMResult._fields},
            {"model": model, "iters_done": done},
        )
        if not bool((acc.stop == int(StopReason.MAX_ITERATIONS)).any()):
            break
    return acc


def fit_per_texel(
    problem: TexelProblem,
    model: str = "blinn_phong",
    opts: LMOptions | None = None,
    device=None,
    engine: str = "auto",
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
    ``engine`` defaults to "auto" as there: the fused LM kernel on a CUDA
    device, the eager LM tier on the CPU (``parallel/fit.py`` lists the
    engines). ``mask_saturation`` zero-weights clipped measurements;
    ``robust`` enables IRLS rounds that downweight outlier views and refit
    warm-started; ``lower``/``upper`` override the model's default box.

    ``checkpointer`` (a :class:`brdf_tpu_torch.utils.checkpoint.FitCheckpointer`)
    with ``chunk_iters > 0`` runs the solve in resumable chunks: the full
    solver state is saved between chunks and a killed run picks up where it
    stopped (``resume=False`` forces a fresh start). Both LM engines carry
    the (μ, ν, stop) continuation state across chunks.
    """
    dev = resolve_device(device)
    spec = MODELS[model]
    if spec.tangent and problem.angles.cos_th is None:
        if problem.geometry is None:
            raise ValueError(
                f"model {model!r} needs tangent-frame angles: build the problem with "
                "tangent_frame=True (or with its geometry)"
            )
        geom = type(problem.geometry)(*(
            x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in problem.geometry))
        ang_np = angles_from_geometry_np(geom, tangent_frame=True)
        problem = problem._replace(angles=ShadingAngles(*(torch.as_tensor(a) for a in ang_np)))
    t, v, c = problem.intensity.shape
    if opts is None:
        opts = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=60)

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

    if checkpointer is not None and chunk_iters > 0:
        res = _fit_chunked(
            model, ang_rep, target, dev, opts, w_rep, engine, checkpointer, chunk_iters,
            resume, lower=lower, upper=upper,
        )
        if robust is not None:
            for _ in range(robust_iters):
                w_irls = robust_weights(spec.fn(res.p, ang_rep) - target, w_rep, kind=robust)
                res = fit_texels(
                    model, ang_rep, target, opts=opts, weights=w_irls, p0=res.p, engine=engine,
                    lower=lower, upper=upper, device=dev,
                )
    else:
        res = fit_texels(
            model, ang_rep, target, opts=opts, weights=w_rep, engine=engine,
            lower=lower, upper=upper, robust=robust,
            robust_iters=robust_iters if robust else 0, device=dev,
        )
    params = res.p.reshape(t, c, spec.n_params)
    result = LMResult(*(x.reshape(t, c) if x.ndim == 1 else x for x in res))
    return FitReport(params=params, face_ids=problem.face_ids, result=result, model=model)
