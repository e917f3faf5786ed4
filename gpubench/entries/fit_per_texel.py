"""Entry ``fit_per_texel``: the per-texel fit of every channel,
``pipeline/fit.py::fit_per_texel`` with the configuration's solver settings
and the traffic's ``engine``; each (texel, channel) is compared."""

from __future__ import annotations

import torch

from gpubench.fitting import FitPool
from gpubench.reference import fit as ref_fit
from gpubench.reference import lobes
from gpubench.reference import problem as ref_problem


class Entry(FitPool):
    units = "texels"

    def fit(self, prob, extra: bool = False):
        from brdf_tpu_torch.pipeline.fit import fit_per_texel

        s = self.config["solver"]
        report = fit_per_texel(prob, self.config["model"], opts=self.opts, device=self.device,
                               engine=self.traffic["engine"],
                               mask_saturation=s["mask_saturation"], robust=s["robust"],
                               robust_iters=s["robust_iters"], lower=s.get("lower"),
                               upper=s.get("upper"))
        out = report.params.cpu().numpy(), report.result.chi2.cpu().numpy()
        if extra:
            out += (report.result.stop.cpu().numpy(), report.result.iters.cpu().numpy())
        return out

    def _cosines(self, prob, dtype):
        pts, nrm, eye, lights, _, _ = ref_problem.tensors(prob, self.device)
        return {k: v.to(dtype) for k, v in lobes.cosines(pts, nrm, eye, lights).items()}

    def observed(self, prob):
        *_, y, w = ref_problem.tensors(prob, self.device)
        return y.permute(0, 2, 1), w.permute(0, 2, 1)                 # (T, C, V)

    def predict(self, prob, p, rows):
        c = self._cosines(prob, torch.float64)
        return ref_fit.texel_model(self.config["model"], {k: v[rows] for k, v in c.items()}, p)

    def reference(self, prob, dtype):
        y, w = self.observed(prob)
        box = self.config["box"]
        return ref_fit.fit_texels(self.config["model"], self._cosines(prob, dtype), y.to(dtype),
                                  w.to(dtype), box["lower"], box["upper"],
                                  self.config["solver"]["robust_iters"])
