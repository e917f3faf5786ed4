"""Entry ``fit_per_texel_tangent``: the per-texel fit of an anisotropic lobe,
whose problem carries the tangent-frame angles. The scans come from the
aniso generator (``traffic/scan_aniso.py``); each problem is built as the
program's command line builds it for a tangent lobe
(``build_pixel_problem(..., tangent_frame=True)``), and fitted by
``pipeline/fit.py::fit_per_texel`` with the configuration's solver settings
and box and the traffic's ``engine``; each (texel, channel) of the five
parameters is compared with the reference of ``reference/ward_aniso.py``."""

from __future__ import annotations

import torch

from gpubench import program
from gpubench.entries.fit_per_texel import Entry as PerTexel
from gpubench.reference import problem as ref_problem
from gpubench.reference import ward_aniso
from gpubench.traffic.scan_aniso import make_scan


class Entry(PerTexel):
    m = 5

    def setup(self) -> None:
        program.build_kernels(self.device)
        self.scans = [make_scan(self.config, self.seed, k, device=self.device)
                      for k in range(self.pool)]
        self.problems = [self.problem(program.scene(s)) for s in self.scans]
        width = self.config["scan"]["width"]
        self.keys = [program.texel_keys(self.config, p, width) for p in self.problems]
        self.opts = program.lm_options(self.config)
        for k in range(self.pool):
            for _ in range(int(self.traffic.get("warm_calls", 2))):
                self.fit(self.problems[k])

    def problem(self, scn):
        from brdf_tpu_torch.pipeline.fit import build_pixel_problem

        c = self.config
        return build_pixel_problem(scn, reference_view=c["reference_view"],
                                   stride=c["pixel_stride"], tangent_frame=True,
                                   shadow_weights=c["solver"]["shadow_weights"])

    def _cosines(self, prob, dtype):
        pts, nrm, eye, lights, _, _ = ref_problem.tensors(prob, self.device)
        return {k: v.to(dtype) for k, v in ward_aniso.cosines(pts, nrm, eye, lights).items()}

    def predict(self, prob, p, rows):
        c = self._cosines(prob, torch.float64)
        return ward_aniso.texel_model({k: v[rows] for k, v in c.items()}, p)

    def reference(self, prob, dtype):
        y, w = self.observed(prob)
        s = self.config["solver"]
        return ward_aniso.fit_texels(self._cosines(prob, dtype), y.to(dtype), w.to(dtype),
                                     s["lower"], s["upper"], s["robust_iters"])
