"""The numbers that decide ``correct``: the program's answers against the
reference's, on the reference's own problem, in float64.

A fit is judged by what it says: its parameters and its χ². For every
(texel, channel) of a per-texel fit, and every face of a joint fit, with at
least m + 1 measurements of positive base weight:

- ``worse_share``: the share whose RMS residual at the program's parameters
  exceeds the RMS residual at the reference's by more than ``tau``;
- ``chi2_mismatch_share``: the share whose reported χ², as an RMS over the
  same measurements, differs from the RMS residual at its own parameters by
  more than ``tau``;
- ``texels_unmatched``: texels that one side has and the other has not.

An image is judged pixel by pixel: ``image_gap`` is the largest
``|program − reference| / max(|reference|, floor)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _rms(pred, y, w):
    n = (w > 0).sum(-1)
    j = ((w * (pred - y)) ** 2).sum(-1)
    return torch.sqrt(j / torch.clamp(n, min=1)), n


def match(ref_keys: np.ndarray, prog_keys: np.ndarray):
    """Indices into the reference's texels of the program's, which of them
    match, and how many texels either side lacks."""
    idx = np.clip(np.searchsorted(ref_keys, prog_keys), 0, max(len(ref_keys) - 1, 0))
    ok = (len(ref_keys) > 0) & (ref_keys[idx] == prog_keys)
    return idx, ok, int((~ok).sum() + len(ref_keys) - ok.sum())


def fit_numbers(predict, y, w, ref_p, ref_keys, prog_keys, prog_p, prog_chi2, m: int,
                tau: float, detail: bool = False) -> dict:
    """``predict(p, rows) → (len(rows), …, N)`` on the reference's problem; ``y``, ``w``
    (T, …, N) float64; ``prog_p`` / ``prog_chi2`` in the program's texel order."""
    dev = y.device
    idx, ok, unmatched = match(ref_keys, prog_keys)
    sel = torch.as_tensor(idx[ok], device=dev)
    y, w = y[sel], w[sel]
    pp = torch.as_tensor(np.asarray(prog_p)[ok], device=dev, dtype=torch.float64)
    chi2 = torch.as_tensor(np.asarray(prog_chi2)[ok], device=dev, dtype=torch.float64)
    rms_ref, n = _rms(predict(ref_p[sel], sel), y, w)
    rms_prog, _ = _rms(predict(pp, sel), y, w)
    eligible = n >= m + 1
    bad = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    gap = torch.where(torch.isfinite(rms_prog), rms_prog - rms_ref, bad)[eligible]
    told = torch.sqrt(torch.clamp(chi2, min=0.0) / torch.clamp(n, min=1))
    off = (told - rms_prog).abs()
    off = torch.where(torch.isfinite(off), off, bad)[eligible]
    count = max(int(eligible.sum()), 1)
    out = {"worse_share": float((gap > tau).sum()) / count,
           "chi2_mismatch_share": float((off > tau).sum()) / count,
           "texels_unmatched": float(unmatched)}
    if detail:
        qs = [0.5, 0.75, 0.9, 0.95, 0.99, 1.0]
        out["detail"] = {
            "gap_quantiles": torch.quantile(gap.clamp(max=1e30), torch.tensor(qs, dtype=gap.dtype, device=dev)).tolist() if len(gap) else [],
            "chi2_off_quantiles": torch.quantile(off.clamp(max=1e30), torch.tensor(qs, dtype=off.dtype, device=dev)).tolist() if len(off) else [],
            "worse_share_at": {str(t): float((gap > t).sum()) / count for t in (1e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2)},
            "chi2_mismatch_share_at": {str(t): float((off > t).sum()) / count for t in (1e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2)},
            "eligible": count}
    return out


def image_gap(img: np.ndarray, ref: np.ndarray, floor: float) -> float:
    img = np.asarray(img, np.float64)
    if img.shape != ref.shape or not np.isfinite(img).all():
        return float("inf")
    return float((np.abs(img - ref) / np.maximum(np.abs(ref), floor)).max())
