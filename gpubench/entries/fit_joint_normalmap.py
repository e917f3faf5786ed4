"""Entry ``fit_joint_normalmap``: the joint normal-map fit,
``pipeline/fit.py::fit_joint_normalmap`` with the configuration's solver
settings, from the program's own start; each face's nine parameters
(kd and ks of three channels, the shared shape, the normal's offsets) and
its χ² over the 3·V measurements are compared."""

from __future__ import annotations

import torch

from gpubench.fitting import FitPool
from gpubench.reference import fit as ref_fit
from gpubench.reference import lobes
from gpubench.reference import problem as ref_problem


class Entry(FitPool):
    units = "texels"
    m = 9

    def fit(self, prob, extra: bool = False):
        from brdf_tpu_torch.pipeline.fit import fit_joint_normalmap

        s = self.config["solver"]
        res, _ = fit_joint_normalmap(prob, self.config["model"], opts=self.opts,
                                     max_tilt=self.config["max_tilt"], engine=s["engine"],
                                     device=self.device, mask_saturation=s["mask_saturation"],
                                     robust=s["robust"], robust_iters=s["robust_iters"])
        out = res.p.cpu().numpy(), res.chi2.cpu().numpy()
        if extra:
            out += (res.stop.cpu().numpy(), res.iters.cpu().numpy())
        return out

    def _geometry(self, prob, dtype=torch.float64):
        """Unit normals and directions, worked out in float64, then in ``dtype``."""
        pts, nrm, eye, lights, _, _ = ref_problem.tensors(prob, self.device)
        return tuple(x.to(dtype) for x in (nrm, *lobes.directions(pts, eye, lights)))

    def observed(self, prob):
        *_, y, w = ref_problem.tensors(prob, self.device)
        return y.permute(0, 2, 1).reshape(len(y), -1), w.permute(0, 2, 1).reshape(len(y), -1)

    def predict(self, prob, p, rows):
        nrm, l, v = self._geometry(prob)
        return ref_fit.joint_model(self.config["model"], nrm[rows], l[rows], v[rows],
                                   p).reshape(len(p), -1)

    def reference(self, prob, dtype):
        *_, y, w = ref_problem.tensors(prob, self.device, dtype)
        box = self.config["box"]
        return ref_fit.fit_joint(self.config["model"], *self._geometry(prob, dtype),
                                 y.permute(0, 2, 1), w.permute(0, 2, 1), box["lower"],
                                 box["upper"], self.config["solver"]["robust_iters"])
