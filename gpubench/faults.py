"""Faults planted in the program's timed path, for showing that the check
catches them (``gpubench/tests/test_faults.py`` on the CPU,
``gpubench/readings.py`` on the card). Each is a context manager that
patches one program function and restores it on exit:

- ``state_unchanged``: the solver returns its start, untouched (a fit: the
  program's own grid start; a relight: the previous request's image);
- ``half_batch``: half of the batch left out (a fit: the second half of the
  texels never solved, their answers zero; a relight: the second half of
  the covered pixels never shaded);
- ``answer_altered``: an answer altered where it is produced (a fit: every
  kd written 1% high, its χ² as it was; a relight: the brightest pixel 5%
  high).

The card has one chip here, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _chi2(model, p, ang, y, w):
    from brdf_tpu_torch.models.brdf import MODELS

    return (((MODELS[model].fn(p, ang) - y) * w) ** 2).sum(-1)


def _texel_fault(fault: str):
    """A stand-in for ``parallel/fit.py::fit_texels`` as ``pipeline/fit.py`` calls it."""
    import brdf_tpu_torch.pipeline.fit as pf
    from brdf_tpu_torch.solver.init import linear_grid_init

    real = pf.fit_texels

    def fit_texels(model, angles, target, **kw):
        if fault == "state_unchanged":
            w = kw.get("weights")
            w = torch.ones_like(target) if w is None else w
            p0 = linear_grid_init(model, angles, target, weights=w)
            res = real(model, angles, target, **kw)
            return res._replace(p=p0, chi2=_chi2(model, p0, angles, target, w))
        if fault == "half_batch":
            half = target.shape[0] // 2
            kw = {k: (v[:half] if isinstance(v, torch.Tensor) and v.shape[:1] == target.shape[:1]
                      else v) for k, v in kw.items()}
            ang = type(angles)(*(None if a is None else a[:half] for a in angles))
            res = real(model, ang, target[:half], **kw)

            def pad(x):
                return torch.cat([x, torch.zeros((target.shape[0] - half,) + x.shape[1:],
                                                 dtype=x.dtype, device=x.device)])
            return type(res)(*(pad(x) for x in res))
        res = real(model, angles, target, **kw)
        p = res.p.clone()
        p[:, 0] *= 1.01
        return res._replace(p=p)

    return mock.patch.object(pf, "fit_texels", fit_texels)


def _joint_fault(fault: str):
    """A stand-in for ``pipeline/fit.py::_joint_solve``."""
    import brdf_tpu_torch.pipeline.fit as pf
    from brdf_tpu_torch.models.normalmap import joint_residual

    real = pf._joint_solve

    def _joint_solve(base_model, spec, opts, max_tilt, engine, p0, geometry, intensity, weights):
        res = real(base_model, spec, opts, max_tilt, engine, p0, geometry, intensity, weights)
        if fault == "state_unchanged":
            r = joint_residual(spec)(p0, (geometry, intensity, weights)).reshape(len(p0), -1)
            return res._replace(p=p0, chi2=(r * r).sum(-1))
        if fault == "half_batch":
            half = len(p0) // 2
            p = res.p.clone()
            p[half:] = 0.0
            chi2 = res.chi2.clone()
            chi2[half:] = 0.0
            return res._replace(p=p, chi2=chi2)
        p = res.p.clone()
        p[:, 0:3] *= 1.01
        return res._replace(p=p)

    return mock.patch.object(pf, "_joint_solve", _joint_solve)


def _relight_fault(fault: str):
    import brdf_tpu_torch.pipeline.render as pr

    if fault == "half_batch":
        real_shade = pr._shade_on_device

        def shade(model, params, points, normals, cam, lights, device):
            out = real_shade(model, params, points, normals, cam, lights, device)
            out[len(out) // 2:] = 0.0
            return out
        return mock.patch.object(pr, "_shade_on_device", shade)
    real = pr.relight
    last = []

    def relight(*args, **kwargs):
        img = real(*args, **kwargs)
        if fault == "state_unchanged":
            out = last[0] if last else img
            last[:] = [img]
            return out
        img = img.copy()
        img[np.unravel_index(np.argmax(img), img.shape)] *= 1.05
        return img
    return mock.patch.object(pr, "relight", relight)


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """Plant ``fault`` under the entry kind ``entry`` while the block runs."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    patch = {"fit_per_texel": _texel_fault, "fit_joint_normalmap": _joint_fault,
             "relight": _relight_fault}[entry](fault)
    with patch:
        yield
