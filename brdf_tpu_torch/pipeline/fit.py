"""The per-texel fit and the scene → problem builders.

Port of ``brdf_tpu/pipeline/fit.py``'s ``TexelProblem``, ``FitReport``,
``fit_per_texel``, ``build_face_problem``, ``build_pixel_problem`` and
``fit_quality_metrics``. The builders are host NumPy (copied): they gather
per-face or per-pixel shading angles and measured intensities from a
:class:`~brdf_tpu_torch.pipeline.scene.Scene` through its z-buffered raster
maps. ``fit_per_texel`` folds channels into the texel batch, masks saturated
measurements, runs one :func:`~brdf_tpu_torch.parallel.fit.fit_texels` call
(init → fit → IRLS rounds) and reshapes the result to ``(T, C, …)``. With a
checkpointer and ``chunk_iters`` the solve runs in resumable chunks
(``_fit_chunked``): the full solver state is saved between chunks and a
killed run picks up where it stopped. ``fit_joint_normalmap`` and
``fit_joint_normalmap_with_gains`` are the joint normal-map tier: m = 9 (or
11) parameters per texel, the three channels sharing the shape and a fitted
normal offset. ``fit_single_material`` fits one parameter set per channel
over every texel's measurements, and ``FitReport.statistics`` gives the
post-fit covariance statistics. ``shadow_weights=True`` in the builders
zero-weights the (texel, light) pairs in cast shadow
(``geometry/visibility.py``).

The fits take ``mesh=`` (``parallel/mesh.py::make_mesh``) beside
``device=``. Every rank builds the same host problem and calls the fit with
the same arguments; the fit pads the folded batch to the mesh with
zero-weight rows, keeps its rank's block (texels by data coordinate, views
by view coordinate; the joint fits shard texels over every rank), fits it
and gathers the blocks, so every rank returns the whole result, as a
single-process JAX mesh does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.geometry.texel import pixel_texels, sample_views
from brdf_tpu_torch.geometry.visibility import light_visibility
from brdf_tpu_torch.models.brdf import (
    MODELS,
    ShadingAngles,
    ShadingGeometry,
    angles_from_geometry_np,
    shading_geometry_np,
)
from brdf_tpu_torch.models.normalmap import (
    JointSpec,
    joint_eval,
    joint_p0_from_channelwise,
    joint_residual,
    joint_spec,
)
from brdf_tpu_torch.ops import joint_levmar
from brdf_tpu_torch.ops.lm import PALLAS_MODELS
from brdf_tpu_torch.ops.ne import JOINT_OPTS, lm_fit_joint_chunked, normal_equations
from brdf_tpu_torch.parallel.fit import (
    FIT_OPTS,
    _resolve_engine,
    fit_texels,
    fit_texels_sharded,
    irls,
    lm_result,
    varpro_result,
)
from brdf_tpu_torch.parallel.mesh import (
    ALL_AXES,
    DATA_AXIS,
    VIEW_AXIS,
    Mesh,
    axis_gather,
    block_of,
    process_count,
    process_index,
    use_mesh,
)
from brdf_tpu_torch.pipeline.diagnostics import estimate_view_gains
from brdf_tpu_torch.pipeline.scene import Scene
from brdf_tpu_torch.solver.init import linear_grid_init
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, StopReason, levmar_bc
from brdf_tpu_torch.solver.robust import robust_weights, saturation_weights
from brdf_tpu_torch.solver.stats import corcoef, covariance_from_normal, stddev
from brdf_tpu_torch.solver.varpro_joint import varpro_fit_joint
from brdf_tpu_torch.utils import profiling
from brdf_tpu_torch.utils.checkpoint import latest_step
from brdf_tpu_torch.utils.profiling import span


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


def _problem_span(build):
    """Record a builder's call as a ``problem.build`` span with its texels
    and views."""

    @functools.wraps(build)
    def wrapper(scene, *args, **kwargs):
        with span("problem.build") as sp:
            problem = build(scene, *args, **kwargs)
            sp.set(texels=len(problem.face_ids), views=scene.num_views)
        return problem

    return wrapper


@_problem_span
def build_face_problem(
    scene: Scene, dtype=np.float32, with_geometry: bool = False,
    tangent_frame: bool = False, shadow_weights: bool = False,
    shadow_resolution: int = 512,
) -> TexelProblem:
    """One texel per *visible* mesh face; per-face intensity = mean over the
    pixels the face covers in each view (z-buffered visibility).

    The reference instead fit every covered pixel separately with its face's
    angles (``brdfdata.cpp:1195-1221``) — equivalent information, ~200× more
    solves for identical per-face results; pixel-level texels come from UV
    texelization (see ``texel.py``) where parameters genuinely vary per pixel.
    """
    mesh = scene.mesh
    f_count = mesh.num_faces
    v_count = scene.num_views

    # Everything here is host-side NumPy (copied from the JAX package):
    # fit_per_texel uploads the finished arrays once.
    sums = np.zeros((v_count, f_count, 3), np.float64)
    counts = np.zeros((v_count, f_count), np.int64)
    for vi in range(v_count):
        rm = scene.raster_map(vi)
        fid = rm.face_id
        cov = fid >= 0
        ids = fid[cov]
        img = scene.images[vi][cov].astype(np.float64)
        # bincount-based segment sum: ~10× faster than np.add.at's
        # element-at-a-time scatter on large covered-pixel sets
        for ch in range(3):
            sums[vi, :, ch] = np.bincount(ids, weights=img[:, ch], minlength=f_count)
        counts[vi] = np.bincount(ids, minlength=f_count)

    visible = counts.sum(axis=0) > 0
    face_ids = np.nonzero(visible)[0]

    c = counts[:, face_ids].T                       # (T, V)
    seen = c > 0
    mean_i = (
        sums[:, face_ids].transpose(1, 0, 2)
        / np.maximum(c, 1)[..., None]
    ).astype(np.float32)                            # (T, V, 3)
    mean_i[~seen] = 0.0
    weights = seen.astype(np.float32)

    centroids = mesh.centroids[face_ids]
    normals = mesh.face_normals[face_ids]
    if shadow_weights:
        # zero-weight (texel, light) pairs in cast shadow — the reference
        # fit those as lit (brdfdata.cpp:1188-1227 has no visibility term)
        weights = weights * light_visibility(
            mesh, centroids, scene.lights, resolution=shadow_resolution
        )
    geom = shading_geometry_np(centroids, normals, scene.eyes(), scene.lights)
    geom = ShadingGeometry(*(a.astype(np.dtype(dtype)) for a in geom))

    return TexelProblem(
        angles=angles_from_geometry_np(
            geom, tangent_frame=tangent_frame, dtype=np.dtype(dtype)
        ),
        intensity=mean_i,
        weights=weights,
        face_ids=face_ids,
        geometry=geom if with_geometry else None,
    )


@_problem_span
def build_pixel_problem(
    scene: Scene,
    reference_view: int = 0,
    stride: int = 1,
    smooth_normals: bool = True,
    dtype=np.float32,
    with_geometry: bool = False,
    tangent_frame: bool = False,
    shadow_weights: bool = False,
    shadow_resolution: int = 512,
) -> TexelProblem:
    """One texel per covered *pixel* of a reference view — the reference's
    actual fit granularity (``brdfdata.cpp:1195-1221``), but with hit-point
    interpolated positions/normals and reprojection sampling with z-buffer
    visibility per view (multi-camera capable)."""
    tex = pixel_texels(
        scene.mesh, scene.raster_map(reference_view), stride=stride,
        smooth_normals=smooth_normals,
    )
    intensity, weights = sample_views(tex, scene)
    if shadow_weights:
        weights = weights * light_visibility(
            scene.mesh, tex.points, scene.lights, resolution=shadow_resolution,
        )

    # host-side NumPy throughout (see build_face_problem)
    geom = shading_geometry_np(tex.points, tex.normals, scene.eyes(), scene.lights)
    geom = ShadingGeometry(*(a.astype(np.dtype(dtype)) for a in geom))
    return TexelProblem(
        angles=angles_from_geometry_np(
            geom, tangent_frame=tangent_frame, dtype=np.dtype(dtype)
        ),
        intensity=intensity.astype(np.dtype(dtype)),
        weights=weights.astype(np.dtype(dtype)),
        face_ids=tex.face_ids,
        geometry=geom if with_geometry else None,
        pixels=tex.pixels,
        points=tex.points,
        normals=tex.normals,
    )


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

    def statistics(self, problem: "TexelProblem") -> dict:
        """Per-(texel, channel) fit statistics — the post-fit analytics
        levmar exposed as ``dlevmar_covar/stddev/corcoef/R2``
        (``levmar/misc_core.c:564-658``), over the whole fit in one batch.
        Returns host arrays: ``stddev`` (T, C, m) parameter standard
        deviations, ``corcoef`` (T, C, m, m) correlation matrices and ``r2``
        (T, C) coefficients of determination.

        The residual is ``(pred − y)·w`` under the problem's weights, as in
        the JAX package; χ² and JᵀJ come from the normal-equation kernel K6
        (``ops/ne.py::normal_equations``, its plain version on the CPU) on
        the device the parameters are on, with the lobe's analytic
        derivatives, and ``n`` of the covariance's degrees of freedom counts
        the views of positive weight."""
        spec = MODELS[self.model]
        params = self.params
        dev = params.device
        t, c, m = params.shape
        with torch.no_grad():
            ang = ShadingAngles(*(
                None if a is None else _as_tensor(a, dev, torch.float32).repeat_interleave(c, 0)
                for a in problem.angles))
            intensity = _as_tensor(problem.intensity, dev, torch.float32)
            v = intensity.shape[1]
            y = intensity.permute(0, 2, 1).reshape(t * c, v)
            w = _as_tensor(problem.weights, dev, torch.float32).repeat_interleave(c, 0)
            p = params.reshape(t * c, m).to(torch.float32)
            chi2, jtj = normal_equations(self.model, p, ang, y, w)         # (T·C,), (T·C, m, m)
            cov = covariance_from_normal(jtj, chi2, torch.sum(w > 0, -1))
            # weighted R²: zero-weight (masked/saturated) views drop out
            pred = torch.where(w > 0, spec.fn(p, ang), y)
            wsum = torch.clamp(torch.sum(w, -1), min=1e-12)
            ybar = torch.sum(w * y, -1) / wsum
            ss_res = torch.sum((w * (y - pred)) ** 2, -1)
            ss_tot = torch.clamp(torch.sum((w * (y - ybar[:, None])) ** 2, -1), min=1e-30)
            r2 = 1.0 - ss_res / ss_tot
        return {
            "stddev": stddev(cov).reshape(t, c, m).cpu().numpy(),
            "corcoef": corcoef(cov).reshape(t, c, m, m).cpu().numpy(),
            "r2": r2.reshape(t, c).cpu().numpy(),
        }


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reprojection(model: str, mask_saturation: bool, params, angles, intensity, weights, gains):
    """Per-channel weighted reprojection error of fitted params against the
    measured intensities (MAE + RMSE over seen views), on tensors.
    ``mask_saturation`` excludes sensor-ceiling measurements per channel,
    consistent with the fit's own masking — a blown-out pixel is not a model
    error (its fraction is reported separately). ``gains`` (V,) scales the
    predictions per view (all-ones when the run fit none).

    params (T, C, m); intensity (T, V, C); weights (T, V)."""
    spec = MODELS[model]
    mae, rmse, sat = [], [], []
    seen = weights > 0
    for ch in range(params.shape[1]):
        pred = spec.fn(params[:, ch, :], angles) * gains[None, :]  # (T, V)
        y = intensity[:, :, ch]
        w = weights
        sat.append(torch.sum((y >= 0.98) & seen) / torch.clamp(torch.sum(seen), min=1))
        if mask_saturation:
            w = w * (y < 0.98)
        # single-w weighting for BOTH metrics: MAE = Σ w·|e| / Σ w,
        # RMSE = √(Σ w·e² / Σ w)
        err = torch.abs(pred - y)
        n = torch.clamp(torch.sum(w), min=1e-12)
        mae.append(torch.sum(w * err) / n)
        rmse.append(torch.sqrt(torch.sum(w * err * err) / n))
    return torch.stack(mae), torch.stack(rmse), torch.stack(sat)


def fit_quality_metrics(
    problem: TexelProblem,
    params: np.ndarray,          # (T, C, m)
    model: str,
    lower=None,
    upper=None,
    chi2: np.ndarray | None = None,
    stop: np.ndarray | None = None,
    mask_saturation: bool = True,
    joint_normals: bool = False,
    view_gains: np.ndarray | None = None,
    device=None,
) -> dict:
    """Quantitative fit-quality audit for a (real-data) run.

    The reference's only self-inspection was printing kd/ks/n averages
    (``brdfdata.cpp:1224-1226``). This computes, per run:

    - per-channel render-vs-photo reprojection error (weighted MAE/RMSE of
      the fitted model against the measured intensities, seen views only),
    - the fraction of texels with each parameter pinned at its box bounds
      (a pinned parameter is either a real material property at the edge of
      the physical range or an unidentifiable DOF parked by the solver —
      either way it belongs in the run record),
    - convergence fraction and χ² summary when solver outputs are supplied,

    and emits a ``warnings`` list for the pathologies that would otherwise
    hide in a summary (a parameter map with kd median 0.0 and ks pinned at
    its upper bound, with nothing flagging it).

    ``device`` is where the reprojection runs (``cuda`` unless the caller
    passes another). ``joint_normals=True`` says the parameters come from a
    joint normal-map fit: a parameter pinned at its upper bound is then no
    longer put down to normal error.
    """
    dev = resolve_device(device)
    spec = MODELS[model]
    params = _to_numpy(params)
    t, c, m = params.shape
    lo = np.ravel(np.asarray(spec.lower if lower is None else lower, np.float64))
    hi = np.ravel(np.asarray(spec.upper if upper is None else upper, np.float64))

    v = problem.intensity.shape[1]
    gains = (np.ones((v,), np.float32) if view_gains is None
             else np.asarray(view_gains, np.float32))
    intensity = _to_numpy(problem.intensity).astype(np.float32)
    w_np = _to_numpy(problem.weights).astype(np.float32)
    if w_np.ndim == 3:
        # per-channel (T, V, 3) weight stacks collapse to the shared view
        # mask for the audit (a view counts as seen if ANY channel saw it;
        # the metric applies its own per-channel saturation mask anyway)
        w_np = w_np.max(-1)
    as_t = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    with torch.no_grad():
        mae, rmse, sat = _reprojection(
            model, bool(mask_saturation), as_t(params),
            ShadingAngles(*(None if a is None else as_t(a) for a in problem.angles)),
            as_t(intensity), as_t(w_np), as_t(gains),
        )
    mae, rmse, sat = (x.cpu().numpy() for x in (mae, rmse, sat))

    out: dict = {
        "model": model,
        "texels": int(t),
        "reprojection_mae": [float(x) for x in mae],
        "reprojection_rmse": [float(x) for x in rmse],
        "saturated_fraction": [float(x) for x in np.asarray(sat)],
        "intensity_mean": [
            float(x) for x in intensity.mean((0, 1))
        ],
    }
    if view_gains is not None:
        out["view_gains"] = [round(float(g), 4) for g in gains]
    at_bounds = {}
    for j, name in enumerate(spec.param_names[:m]):
        vals = params[:, :, j]
        span = max(hi[j] - lo[j], 1e-12)
        at_lo = float((vals <= lo[j] + 1e-6 * span).mean())
        at_hi = float((vals >= hi[j] - 1e-6 * span).mean())
        at_bounds[name] = {"lower": at_lo, "upper": at_hi}
    out["fraction_at_bounds"] = at_bounds

    if chi2 is not None:
        chi2 = _to_numpy(chi2)
        out["chi2"] = {
            "median": float(np.median(chi2)),
            "p90": float(np.percentile(chi2, 90)),
        }
    if stop is not None:
        out["converged_fraction"] = float(
            np.isin(_to_numpy(stop), (1, 2, 6)).mean()
        )

    warnings = []
    if model == "cook_torrance_fresnel":
        # Documented ambiguity (measured, not hypothetical): ks·F(f0)
        # couples the two specular scales; at 16 views synthetic recovery
        # tops out at 0.78 even with the exact scale-profiled solve, with
        # χ² at the floor — see the model docstring. The parameter MAPS
        # can be non-unique even when the reprojection error is good.
        warnings.append(
            "model cook_torrance_fresnel: ks and f0 are coupled (ks·F(f0)) "
            "and only weakly identifiable at rig-scale view counts — "
            "individual ks/f0 maps may be non-unique even at low "
            "reprojection error; trust ks·F(f0) and compare against plain "
            "cook_torrance before using f0 quantitatively"
        )
    mean_i = max(float(np.mean(out["intensity_mean"])), 1e-9)
    for ch, e in enumerate(mae):
        if e > 0.5 * mean_i:
            warnings.append(
                f"channel {ch}: reprojection MAE {e:.4f} exceeds half the "
                f"mean measured intensity ({mean_i:.4f}) — the fit does not "
                "explain the photos"
            )
    for name, fr in at_bounds.items():
        if fr["upper"] > 0.2:
            msg = (
                f"param {name}: {fr['upper']:.0%} of texels pinned at the "
                f"UPPER bound — raise the bound or suspect non-identifiability"
            )
            if not joint_normals:
                # Scanned-normal error launders into clamped specular params
                # (the JAX package measured ks pinned on 59% of a scanned
                # bunny's texels per channel against 3% under the joint fit).
                msg += (
                    "; on real scans this usually means normal error — "
                    "refit with the joint normal-map tier "
                    "(ModelConfig.joint_normalmap / the *-joint presets)"
                )
            warnings.append(msg)
        if fr["lower"] > 0.5:
            warnings.append(
                f"param {name}: {fr['lower']:.0%} of texels at the LOWER "
                "bound — verify against the reprojection error before "
                "trusting the maps"
            )
    out["warnings"] = warnings
    return out


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


def _fit_device(device, mesh: Mesh | None) -> torch.device:
    """Where a fit runs: ``mesh.device`` with a mesh, else ``device``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        raise ValueError("pass device= or mesh=, not both: a mesh's fit runs on mesh.device")
    return mesh.device


def _pad_rows(x: torch.Tensor, pad: int, repeat: bool) -> torch.Tensor:
    """``x`` with ``pad`` more rows: copies of its first (``repeat``) or zeros."""
    if not pad:
        return x
    fill = x[:1] if repeat else torch.zeros_like(x[:1])
    return torch.cat([x, fill.expand(pad, *x.shape[1:])])


def _texel_view_block(mesh: Mesh, angles: ShadingAngles, target, weights):
    """This rank's block of a folded ``(N, V)`` batch: padded with zero-weight
    rows (the first row's angles, zero target) to a multiple of the data
    axis, then the rows of its data coordinate and the views of its view
    coordinate."""
    n, v = target.shape
    if v % mesh.view:
        raise ValueError(f"{v} views do not split over a view axis of {mesh.view}")
    pad = (-n) % mesh.data
    d, vi = mesh.coords
    rows, cols = block_of(n + pad, mesh.data, d), block_of(v, mesh.view, vi)

    def cut(x, repeat):
        return _pad_rows(x, pad, repeat)[rows, cols].contiguous()

    return (ShadingAngles(*(None if a is None else cut(a, True) for a in angles)),
            cut(target, False), cut(weights, False))


def _gather_rows(res: LMResult, mesh: Mesh | None, axis, n: int | None = None) -> LMResult:
    """Every rank's block of ``res`` along ``axis`` in rank order, cut to ``n``
    rows; ``res`` itself without a mesh."""
    if mesh is None:
        return res
    with use_mesh(mesh):
        full = LMResult(*(axis_gather(x, axis) for x in res))
    return full if n is None else LMResult(*(x[:n] for x in full))


def _fit_block(model, angles, target, dev, mesh, **kw) -> LMResult:
    if mesh is None:
        return fit_texels(model, angles, target, device=dev, **kw)
    return fit_texels_sharded(model, angles, target, mesh, **kw)


def _fit_chunked(
    model, angles, target, dev, opts, weights, engine, checkpointer,
    chunk_iters, resume, lower=None, upper=None, mesh=None,
) -> LMResult:
    """Run the fit in chunks of ``chunk_iters`` outer iterations,
    checkpointing the full solver state (p, μ, ν, stop, counters) between
    chunks and resuming from the newest checkpoint when it fits this problem.
    Already-terminated lanes short-circuit in later chunks.

    With a mesh ``angles``/``target``/``weights`` are the rank's block; after
    each chunk the blocks are gathered, whether to go on is decided on the
    whole batch (so every rank takes the same number of chunks), and each
    process writes its share of the rows as its checkpoint shard
    (``utils/checkpoint.py``). Returns the rank's block."""
    t = target.shape[0]
    data = 1 if mesh is None else mesh.data
    rows = block_of(t * data, data, 0 if mesh is None else mesh.coords[0])
    full: LMResult | None = None
    done = 0
    if resume and latest_step(checkpointer.path) is not None:
        arrays, meta = checkpointer.restore()
        if meta.get("model") == model and arrays["p"].shape[0] == t * data:
            full = LMResult(**{k: torch.as_tensor(np.asarray(arrays[k]), device=dev)
                               for k in LMResult._fields})
            done = int(meta["iters_done"])

    acc = None
    while done < opts.itmax:
        if full is None:
            p0, warm, active = None, None, torch.ones(t, dtype=torch.bool, device=dev)
        else:
            if not bool((full.warm_state()[2] == int(StopReason.RUNNING)).any()):
                break
            acc = LMResult(*(x[rows] for x in full))
            warm = acc.warm_state()
            active = warm[2] == int(StopReason.RUNNING)
            p0 = acc.p
        step = min(chunk_iters, opts.itmax - done)
        res = _fit_block(
            model, angles, target, dev, mesh, opts=opts._replace(itmax=step), weights=weights,
            p0=p0, engine=engine, warm_state=warm, lower=lower, upper=upper,
        )
        acc = res if full is None else _merge_chunk(acc, res, active)
        done += step
        full = _gather_rows(acc, mesh, DATA_AXIS)
        share = process_index(), process_count()
        checkpointer.maybe_save(
            done,
            {k: np.array_split(getattr(full, k).detach().cpu().numpy(), share[1])[share[0]]
             for k in LMResult._fields},
            {"model": model, "iters_done": done},
        )
        if not bool((full.stop == int(StopReason.MAX_ITERATIONS)).any()):
            break
    return LMResult(*(x[rows] for x in full))


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
    mesh: Mesh | None = None,
) -> FitReport:
    """Fit every (texel, channel) independently — T·C problems, batched.

    The arguments are those of the JAX ``fit_per_texel``, and ``device=``
    (``cuda`` unless the caller passes another) runs it on one device. With
    ``mesh=`` (``parallel/mesh.py::make_mesh``, on ``mesh.device``) every
    rank of the mesh calls it with the same problem: each fits its block of
    the folded batch (``parallel/fit.py::fit_texels_sharded``) and every rank
    returns the whole report. The view count must divide over the view axis.
    ``engine`` defaults to "auto" as there: the fused LM kernel on a CUDA
    device, the eager LM tier on the CPU (``parallel/fit.py`` lists the
    engines). ``mask_saturation`` zero-weights clipped measurements;
    ``robust`` enables IRLS rounds that downweight outlier views and refit
    warm-started; ``lower``/``upper`` override the model's default box.

    ``checkpointer`` (a :class:`brdf_tpu_torch.utils.checkpoint.FitCheckpointer`)
    with ``chunk_iters > 0`` runs the solve in resumable chunks: the full
    solver state is saved between chunks and a killed run picks up where it
    stopped (``resume=False`` forces a fresh start). Both LM engines carry
    the (μ, ν, stop) continuation state across chunks; the VarPro engine,
    whose whole continuation state is the start, begins each chunk after the
    first from the parameters the last one returned (K1, K8 and
    ``varpro_fit_fresnel_lin`` all skip their grid for a start).
    """
    t, v, c = problem.intensity.shape
    with span("fit", texels=t, views=v, channels=c, engine=engine):
        dev = _fit_device(device, mesh)
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
            problem = problem._replace(
                angles=ShadingAngles(*(torch.as_tensor(a) for a in ang_np)))
        if opts is None:
            opts = FIT_OPTS

        # fold channels into the batch: angles/weights repeat per channel
        with span("fit.upload") as up:
            ang_rep = ShadingAngles(*(
                None if a is None else torch.as_tensor(a).to(dev).repeat_interleave(c, dim=0)
                for a in problem.angles
            ))
            intensity = torch.as_tensor(problem.intensity).to(dev)
            target = intensity.permute(0, 2, 1).reshape(t * c, v)
            w_rep = torch.as_tensor(problem.weights).to(dev).repeat_interleave(c, dim=0)
            if profiling.enabled():
                up.set(bytes=_nbytes(*problem.angles, problem.intensity, problem.weights))
        if mask_saturation:
            w_rep = w_rep * saturation_weights(target)
        if mesh is not None:
            ang_rep, target, w_rep = _texel_view_block(mesh, ang_rep, target, w_rep)
        view_axis = VIEW_AXIS if mesh is not None and mesh.view > 1 else None

        if checkpointer is not None and chunk_iters > 0:
            def reweight(r):
                with use_mesh(mesh):
                    return robust_weights(spec.fn(r.p, ang_rep) - target, w_rep, kind=robust,
                                          axis_name=view_axis)

            # the rounds after the checkpointed one refit from the previous
            # round's parameters, whatever the engine
            res = irls(
                lambda: _fit_chunked(
                    model, ang_rep, target, dev, opts, w_rep, engine, checkpointer, chunk_iters,
                    resume, lower=lower, upper=upper, mesh=mesh),
                reweight,
                lambda w, r: _fit_block(
                    model, ang_rep, target, dev, mesh, opts=opts, weights=w, p0=r.p,
                    engine=engine, lower=lower, upper=upper),
                robust_iters if robust is not None else 0)
        else:
            res = _fit_block(
                model, ang_rep, target, dev, mesh, opts=opts, weights=w_rep, engine=engine,
                lower=lower, upper=upper, robust=robust,
                robust_iters=robust_iters if robust else 0,
            )
        res = _gather_rows(res, mesh, DATA_AXIS, t * c)
        params = res.p.reshape(t, c, spec.n_params)
        result = LMResult(*(x.reshape(t, c) if x.ndim == 1 else x for x in res))
    return FitReport(params=params, face_ids=problem.face_ids, result=result, model=model)


def _as_tensor(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def _nbytes(*arrays) -> int:
    """Bytes of the host arrays or tensors given (None counts nothing)."""
    return sum(int(a.nbytes) for a in arrays if a is not None)


def _joint_solve(base_model, spec: JointSpec, opts, max_tilt, engine, p0, geometry, intensity,
                 weights) -> LMResult:
    """One joint solve from start ``p0`` (T, 8+k) under weights (T, V, 3)."""
    if engine == "varpro":
        # 3-D profiled variable projection (solver/varpro_joint.py): the six
        # kd/ks parameters are eliminated in closed form per iteration, for a
        # fixed iteration count. Cheaper per lane than the LM tiers, which win
        # the identifiability-limited normal tail: the fast tier, not the
        # default. The per-channel start is derived from p0.
        chan_p = torch.stack(
            [torch.stack([p0[:, c], p0[:, 3 + c], p0[:, 6]], -1) for c in range(3)], dim=1)
        k = min(opts.itmax, 12)
        r, _ = varpro_fit_joint(base_model, geometry, intensity, weights=weights,
                                channel_params=chan_p, iters=k, max_tilt=max_tilt)
        return varpro_result(r, k)
    if engine == "pallas":
        return lm_result(lm_fit_joint_chunked(base_model, geometry, intensity, p0, weights=weights,
                                              opts=opts, lower=tuple(spec.lower),
                                              upper=tuple(spec.upper)))
    if joint_levmar.kernel_takes(spec, opts, p0, intensity, weights, *geometry):
        # levmar_bc's state machine for every face in one launch of
        # csrc/joint_levmar.cu (the m = 11 anisotropic bases on a card)
        return joint_levmar.joint_levmar(spec, geometry, intensity, p0, weights, opts)
    return levmar_bc(joint_residual(spec), p0, spec.lower, spec.upper,
                     data=(geometry, intensity, weights), opts=opts)


def fit_joint_normalmap(
    problem: TexelProblem,
    base_model: str = "cook_torrance",
    opts: LMOptions | None = None,
    channel_report: FitReport | None = None,
    max_tilt: float = 0.6,
    engine: str = "auto",
    device=None,
    mask_saturation: bool = True,
    robust: str | None = None,
    robust_iters: int = 2,
    mesh: Mesh | None = None,
):
    """Jointly fit per-texel normals + material: m = 9 params (RGB kd, RGB ks,
    shared shape, tangent normal offset; m = 11 around an anisotropic base),
    n = 3·V residuals, box-constrained (the box on the offsets bounds the
    tilt). Returns ``(LMResult, JointSpec)``.

    Needs a problem built ``with_geometry=True``. Starts from independent
    per-channel fits when supplied (``channel_report``), else from the linear
    grid initializer per channel under that channel's weights.

    Weights are per channel throughout (the channels are independent
    measurements): ``problem.weights`` (T, V), or already (T, V, 3), composes
    with the per-channel saturation mask (``mask_saturation``, on by default
    like that of the per-texel fit) and with per-(channel, view) IRLS robust
    reweighting of the joint residual (``robust``/``robust_iters`` —
    "huber"/"cauchy"/"tukey" rounds, each a refit from the previous round's
    parameters, exactly as in :func:`fit_per_texel`).

    ``engine``: "xla" (``levmar_bc``: eager with a forward-mode Jacobian through
    ``perturbed_angles``; for the m = 11 bases on float32 CUDA tensors its
    whole solve in one launch of ``ops/joint_levmar.py``'s kernel), "pallas"
    (``ops/ne.py::lm_fit_joint_chunked``: the
    m=9 normal-equation kernel K7, with the angles and their offset partials
    evaluated in the kernel; its plain version on the CPU), "varpro"
    (``solver/varpro_joint.py``), or "auto": "pallas" on a CUDA device when
    the base lobe has one shape parameter, else "xla". The m = 11 fit runs on
    "xla" only.

    The arguments are those of the JAX ``fit_joint_normalmap``; ``device=``
    (``cuda`` unless the caller passes another) runs it on one device. With
    ``mesh=`` every rank of the mesh calls it with the same problem, the
    texels are sharded over every rank (whatever the mesh's shape, as the
    JAX package shards them over every axis), and every rank returns the
    whole result.
    """
    t, v, c = problem.intensity.shape
    with span("fit", texels=t, views=v, channels=c, engine=engine) as root:
        if problem.geometry is None:
            raise ValueError("joint fit requires build_face_problem(with_geometry=True)")
        dev = _fit_device(device, mesh)
        spec = joint_spec(base_model, max_tilt=max_tilt)
        if opts is None:
            opts = JOINT_OPTS
        engine = _resolve_engine(engine, dev.type,
                                 base_model in PALLAS_MODELS and spec.n_shape == 1)
        if spec.n_shape != 1 and engine in ("pallas", "varpro"):
            raise ValueError(
                f"joint engine {engine!r} supports single-shape (m=9) bases; "
                f"the m={spec.n_params} joint fit for {base_model!r} runs on "
                "engine='xla' (forward-mode Jacobian through perturbed_angles)"
            )
        root.set(engine=engine)
        with span("fit.upload") as up:
            intensity = _as_tensor(problem.intensity, dev)
            dtype = intensity.dtype
            angles = ShadingAngles(*(None if a is None else _as_tensor(a, dev)
                                     for a in problem.angles))
            geometry = ShadingGeometry(*(_as_tensor(x, dev) for x in problem.geometry))
            # per-channel weight stack (T, V, 3): the base weights (visibility
            # masks, shared (T, V), or already per channel, e.g. a mask computed
            # against unscaled measurements) times the per-channel saturation mask
            w_base = _as_tensor(problem.weights, dev, dtype)
            weights = w_base[..., None].repeat(1, 1, c) if w_base.ndim == 2 else w_base
            if profiling.enabled():
                up.set(bytes=_nbytes(problem.intensity, *problem.angles, *problem.geometry,
                                     problem.weights))
        if mask_saturation:
            weights = weights * saturation_weights(intensity)
        chan = None if channel_report is None else _as_tensor(channel_report.params, dev, dtype)
        if mesh is not None:
            # this rank's block of the texels, padded with zero-weight copies of
            # the first texel to a multiple of every rank
            pad = (-t) % mesh.world
            rows = block_of(t + pad, mesh.world, mesh.rank)

            def cut(x, repeat=True):
                return None if x is None else _pad_rows(x, pad, repeat)[rows].contiguous()

            angles = ShadingAngles(*map(cut, angles))
            geometry = ShadingGeometry(*map(cut, geometry))
            intensity, weights, chan = cut(intensity), cut(weights, False), cut(chan)

        with torch.no_grad():
            if chan is None:
                # every channel in one call: the angles (T, 1, V) broadcast
                # against the (T, C, V) measurements → (T, C, m); contiguous,
                # so that the view sums run as in a call for one channel
                per_texel = ShadingAngles(*(None if a is None else a[:, None] for a in angles))
                chan = linear_grid_init(base_model, per_texel,
                                        intensity.transpose(1, 2).contiguous(),
                                        weights=weights.transpose(1, 2).contiguous())
            p0 = joint_p0_from_channelwise(chan)                               # (T, 8+k)

            def solve(p_start, w):
                return _joint_solve(base_model, spec, opts, float(max_tilt), engine, p_start,
                                    geometry, intensity, w)

            def reweight(r):
                # per-channel robust weights from the JOINT residual (the fitted
                # normal is part of the model, so shadowed and outlier views are
                # downweighted against the joint prediction, not the raw-normal one)
                resid = joint_eval(spec, r.p, geometry) - intensity          # (T, V, 3)
                return robust_weights(resid.permute(0, 2, 1), weights.permute(0, 2, 1),
                                      kind=robust).permute(0, 2, 1)

            res = irls(lambda: solve(p0, weights), reweight, lambda w, r: solve(r.p, w),
                       int(robust_iters) if robust else 0)
        out = _gather_rows(res, mesh, ALL_AXES, t)
    return out, spec


def fit_joint_normalmap_with_gains(
    problem: TexelProblem,
    base_model: str = "cook_torrance",
    rounds: int = 2,
    mask_saturation: bool = True,
    **kwargs,
):
    """Joint normal-map fit with per-view rig gains as nuisance parameters
    (alternation: joint fit ↔ closed-form gain solve, clamped to [0.5, 2]).

    The reference hard-coded equal-intensity LEDs. The per-channel saturation
    mask is computed once against the unscaled measurements and frozen across
    the alternation (scaling the targets must not move the mask). Returns
    ``(res, spec, gains)``; the fitted forward model of the scan is
    ``gains[v] · model(params)`` (renders under novel lights ignore the gains:
    they are a property of the rig, not the material). ``kwargs`` go to
    :func:`fit_joint_normalmap`. Each gain round's prediction, its copy to
    the host and the gain solve are a ``fit.gains`` span (round, views).
    """
    intensity = _to_numpy(problem.intensity)
    w_base = _to_numpy(problem.weights).astype(intensity.dtype)
    w3 = np.repeat(w_base[..., None], intensity.shape[-1], -1) if w_base.ndim == 2 else w_base
    if mask_saturation:
        w3 = w3 * (intensity < 0.98).astype(intensity.dtype)

    gains = np.ones((intensity.shape[1],), np.float64)
    res = spec = None
    for r in range(rounds + 1):
        scaled = intensity / np.maximum(gains[None, :, None], 1e-3)
        prob = problem._replace(intensity=scaled.astype(intensity.dtype), weights=w3)
        res, spec = fit_joint_normalmap(prob, base_model, mask_saturation=False, **kwargs)
        if r == rounds:
            break
        with torch.no_grad(), span("fit.gains", round=r + 1, views=len(gains)):
            geometry = ShadingGeometry(*(_as_tensor(x, res.p.device) for x in problem.geometry))
            pred = joint_eval(spec, res.p, geometry).cpu().numpy()
            gains = estimate_view_gains(pred, intensity, w3)
    return res, spec, gains


def _median0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: the mean of the two middle values for an
    even count (``torch.median`` takes the lower one)."""
    srt = torch.sort(x, dim=0).values
    n = srt.shape[0]
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


def fit_single_material(
    problem: TexelProblem,
    model: str = "blinn_phong",
    opts: LMOptions | None = None,
    device=None,
) -> torch.Tensor:
    """One global parameter set per channel over all texels' measurements
    (n = T·V residuals), the ``SolveEquation_SingleBRDF`` path
    (``brdfdata.cpp:991-1075``; itmax there was 2000). Returns (C, m) on
    ``device`` (``cuda`` unless the caller passes another).

    Each channel starts from the median over texels of its per-texel
    ``linear_grid_init``; the channels then solve as one batch of C
    problems of ``levmar_bc`` sharing the angles and weights
    (``data_axes=(None, 0, None)``), in float32 as in the JAX package."""
    dev = resolve_device(device)
    spec = MODELS[model]
    if opts is None:
        opts = LMOptions(eps1=1e-8, eps2=1e-10, eps3=1e-16, itmax=300)
    ang = ShadingAngles(*(None if a is None else _as_tensor(a, dev) for a in problem.angles))
    # (C, T, V) channel-major: every channel is one problem of the batch
    targets = _as_tensor(problem.intensity, dev, torch.float32).permute(2, 0, 1).contiguous()
    w = _as_tensor(problem.weights, dev, torch.float32)

    def residual(p, data):
        a, y, ww = data
        return ((spec.fn(p, a) - y) * ww).reshape(-1)

    with torch.no_grad():
        # every channel in one call: (C, T, V) targets → (C, T, m) starts
        p0 = _median0(linear_grid_init(model, ang, targets, weights=w).transpose(0, 1))
    res = levmar_bc(residual, p0, spec.lower, spec.upper, data=(ang, targets, w), opts=opts,
                    data_axes=(None, 0, None))
    return res.p
