"""Entry ``fit_joint_normalmap_gains``: the joint normal-map fit with per-view
rig gains around an anisotropic lobe, as the program's command line runs a
configuration with ``fit_view_gains``. The scans come from the joint aniso
generator (``traffic/scan_joint_aniso.py``); each problem is built as the
command line builds it for a tangent lobe (``build_face_problem(...,
with_geometry=True, tangent_frame=True)``), and fitted by
``pipeline/fit.py::fit_joint_normalmap_with_gains`` with the
configuration's solver settings and gain rounds.

A face's answer is its eleven parameters followed by the call's V gains,
and its χ², which the program reports on the gain-corrected measurements.
The check compares against ``reference/joint_aniso.py``:

- ``worse_share`` and ``texels_unmatched`` on the measurements as taken,
  each side predicting g_v · model(p) with its own gains;
- ``chi2_mismatch_share`` in the program's own frame, the measurements
  divided by its gains, where its χ² lives;
- ``gain_gap``: the largest |g_program − g_reference| ÷ g_reference over
  the views.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import program
from gpubench.entries.fit_joint_normalmap import Entry as Joint
from gpubench.reference import joint_aniso, judge
from gpubench.reference import problem as ref_problem
from gpubench.traffic.scan_joint_aniso import make_scan


class Entry(Joint):
    m = 11

    def setup(self) -> None:
        program.build_kernels(self.device)
        self.scans = [make_scan(self.config, self.seed, k, device=self.device)
                      for k in range(self.pool)]
        self.problems = [self.problem(program.scene(s)) for s in self.scans]
        width = self.config["scan"]["width"]
        self.keys = [program.texel_keys(self.config, p, width) for p in self.problems]
        self.opts = program.lm_options(self.config)
        # every scan of a configuration has the same faces seen (the seed
        # draws the materials, not the geometry), so the pool shares every
        # shape: the warm-up fits the first scan alone
        for _ in range(int(self.traffic.get("warm_calls", 1))):
            self.fit(self.problems[0])

    def problem(self, scn):
        from brdf_tpu_torch.pipeline.fit import build_face_problem

        return build_face_problem(scn, with_geometry=True, tangent_frame=True,
                                  shadow_weights=self.config["solver"]["shadow_weights"])

    def fit(self, prob, extra: bool = False):
        from brdf_tpu_torch.pipeline.fit import fit_joint_normalmap_with_gains

        s = self.config["solver"]
        res, _, gains = fit_joint_normalmap_with_gains(
            prob, self.config["model"], rounds=s["view_gain_rounds"],
            mask_saturation=s["mask_saturation"], opts=self.opts,
            max_tilt=self.config["max_tilt"], engine=s["engine"], device=self.device,
            robust=s["robust"], robust_iters=s["robust_iters"])
        p = res.p.cpu().numpy()
        g = np.broadcast_to(np.asarray(gains, p.dtype), (len(p), len(gains)))
        out = np.concatenate([p, g], -1), res.chi2.cpu().numpy()
        if extra:
            out += (res.stop.cpu().numpy(), res.iters.cpu().numpy())
        return out

    def _model(self, prob, p, rows):
        nrm, l, v = self._geometry(prob)
        return joint_aniso.joint_model(nrm[rows], l[rows], v[rows], p[:, :self.m])

    def predict(self, prob, p, rows):
        """g_v · model(p) with each row's own gains: (len(rows), 3·V)."""
        return (self._model(prob, p, rows) * p[:, None, self.m:]).reshape(len(p), -1)

    def reference(self, prob, dtype):
        *_, y, w = ref_problem.tensors(prob, self.device, dtype)
        box = self.config["box"]
        p, gains, chi2 = joint_aniso.fit_joint_gains(
            *self._geometry(prob, dtype), y.permute(0, 2, 1), w.permute(0, 2, 1), box["lower"],
            box["upper"], self.config["solver"]["view_gain_rounds"])
        return torch.cat([p, gains.expand(len(p), -1)], -1), chi2

    def judge(self, samples, answers=None, detail: bool = False) -> dict:
        out = {"detail": []} if detail else {}
        tau = float(self.traffic["check"]["tau"])
        for k, params, chi2 in samples:
            prob = self.reference_problem(k)
            if ("fit", k) not in self.ref_cache:
                self.ref_cache["fit", k] = self.reference(prob, torch.float64)[0]
            ref = self.ref_cache["fit", k]
            keys = self.keys[k]
            if answers is not None:
                keys = prob.keys
                params, chi2 = answers(k)
            params = np.asarray(params, np.float64)
            y, w = self.observed(prob)
            nums = judge.fit_numbers(lambda p, rows: self.predict(prob, p, rows), y, w, ref,
                                     prob.keys, keys, params, chi2, self.m, tau, detail)
            g_ref = ref[0, self.m:].cpu().numpy()
            g_prog = params[0, self.m:] if len(params) else np.full_like(g_ref, np.nan)
            # the χ² in the frame it was reported in: the measurements over the program's gains
            g = torch.as_tensor(g_prog, device=y.device).repeat(y.shape[1] // len(g_prog))
            own = judge.fit_numbers(
                lambda p, rows: self._model(prob, p, rows).reshape(len(p), -1), y / g, w, ref,
                prob.keys, keys, params, chi2, self.m, tau, detail)
            nums["chi2_mismatch_share"] = own["chi2_mismatch_share"]
            gap = np.abs(g_prog - g_ref) / g_ref
            nums["gain_gap"] = float(gap.max()) if np.isfinite(gap).all() else float("inf")
            if detail:
                d = nums.pop("detail")
                mine = own.pop("detail")
                d.update({key: mine[key] for key in ("chi2_off_quantiles",
                                                     "chi2_mismatch_share_at")})
                d.update(gains_program=g_prog.tolist(), gains_reference=g_ref.tolist())
                out["detail"].append(d)
            for name, value in nums.items():
                out[name] = max(out.get(name, value), value)
        return out
