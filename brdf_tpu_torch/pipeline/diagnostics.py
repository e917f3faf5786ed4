"""Fit diagnostics beyond per-texel statistics: rig-level nuisance
parameters and spatial residual structure.

Copied from ``brdf_tpu/pipeline/diagnostics.py`` (host NumPy throughout).
The reference hard-coded its rig assumptions — equal-intensity LEDs
(``brdfdata.cpp:683-797`` stores positions only) and a fixed Tsai
calibration — and had no way to test them. These tools do:

- :func:`estimate_view_gains` / :func:`fit_view_gains`: one multiplicative
  gain per view (optionally per channel), fitted jointly with the material
  by closed-form alternation. If the LEDs are NOT equal-intensity (or
  exposures drift between shots), the per-texel fit launders the error into
  biased parameters; a fitted gain vector absorbs it with V extra DOF
  against ~10⁴-10⁵ texels.
- :func:`residual_view_image`: the signed render-vs-photo residual laid out
  over a view — interreflections, unmodeled shadows, and calibration bias
  are SPATIALLY STRUCTURED there, while sensor noise is not.
"""

from __future__ import annotations

import numpy as np


def estimate_view_gains(
    pred: np.ndarray,        # (T, V, C) model predictions
    intensity: np.ndarray,   # (T, V, C) measurements
    weights: np.ndarray,     # (T, V) or (T, V, C)
    per_channel: bool = False,
) -> np.ndarray:
    """Closed-form least-squares gains: ``g_v = Σ w²·pred·y / Σ w²·pred²``
    over texels (and channels unless ``per_channel``), normalized to mean 1
    (a global scale is degenerate with kd/ks). Returns (V,) or (V, C)."""
    pred = np.asarray(pred, np.float64)
    y = np.asarray(intensity, np.float64)
    w = np.asarray(weights, np.float64)
    if w.ndim == 2:
        w = w[..., None]
    w2 = np.broadcast_to(w * w, pred.shape)
    axes = (0,) if per_channel else (0, 2)
    num = np.sum(w2 * pred * y, axis=axes)
    den = np.maximum(np.sum(w2 * pred * pred, axis=axes), 1e-30)
    g = num / den
    g = np.where(den > 1e-20, g, 1.0)
    # clamp before normalizing: a view whose predictions are weak (heavily
    # masked, grazing) can otherwise collapse its gain toward 0 and blow up
    # the 1/g-scaled refit targets. Physical LED/exposure variation is tens
    # of percent, not 200×.
    g = np.clip(g, 0.5, 2.0)
    mean = np.mean(g) if g.size else 1.0
    return (g / max(mean, 1e-12)).astype(np.float64)


def fit_view_gains(
    fit_fn,
    predict_fn,
    intensity: np.ndarray,    # (T, V, C)
    weights: np.ndarray,      # (T, V) or (T, V, C)
    rounds: int = 2,
    per_channel: bool = False,
):
    """Alternate material fit ↔ closed-form gain estimate.

    ``fit_fn(y_scaled) -> state`` runs the material fit against
    gain-corrected measurements; ``predict_fn(state) -> (T, V, C)`` predicts
    in the ORIGINAL (unscaled) units. Returns ``(state, gains)`` with
    ``gains`` shaped (V,) or (V, C); the fitted forward model is
    ``gains · predict``. Two rounds suffice in practice — the gain solve is
    exact given the material and vice versa, so the alternation is a block
    coordinate descent on a smooth objective."""
    gains = None
    state = fit_fn(np.asarray(intensity))
    for _ in range(rounds):
        pred = np.asarray(predict_fn(state))
        gains = estimate_view_gains(pred, intensity, weights,
                                    per_channel=per_channel)
        gv = gains if per_channel else gains[:, None]
        state = fit_fn(np.asarray(intensity) / np.maximum(gv, 1e-6))
    return state, gains


def residual_view_image(
    scene,
    view: int,
    render: np.ndarray,       # (H, W, C) model render of the view (its LED)
) -> tuple[np.ndarray, dict]:
    """Signed photo-minus-render residual for one view.

    Returns ``(rgb, stats)``: ``rgb`` is a diverging visualization (photo
    brighter than the model → red, darker → blue, matched → black; scaled
    to the 99th-percentile |residual|), ``stats`` holds the per-channel
    mean/median signed residual and the positive-residual fraction —
    interreflections show up as spatially coherent POSITIVE residual
    (light the model cannot produce), cast shadows as negative."""
    photo = np.asarray(scene.images[view], np.float64)
    render = np.asarray(render, np.float64)
    cov = render.sum(-1) > 0
    resid = np.where(cov[..., None], photo - render, 0.0)
    scale = max(float(np.percentile(np.abs(resid[cov]), 99)), 1e-6) if cov.any() else 1.0
    r = np.clip(resid.mean(-1) / scale, -1.0, 1.0)
    rgb = np.zeros(photo.shape[:2] + (3,), np.float32)
    rgb[..., 0] = np.clip(r, 0, 1)
    rgb[..., 2] = np.clip(-r, 0, 1)
    stats = {
        "residual_scale_p99": scale,
        "mean_signed": [float(x) for x in resid[cov].mean(0)] if cov.any() else [],
        "median_signed": [float(x) for x in np.median(resid[cov], 0)] if cov.any() else [],
        "positive_fraction": float((resid[cov].mean(-1) > 0).mean()) if cov.any() else 0.0,
    }
    return rgb, stats
