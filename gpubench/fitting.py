"""The fit cells' shared traffic: one caller fits a rotating pool of scans
made from the seed, each request one scan's fit, ended with its parameters
and χ² on the host as the program's command line takes them. The check
fits each sampled request's scan again with the reference and judges the
program's answers against it (``reference/judge.py``)."""

from __future__ import annotations

import numpy as np
import torch

from gpubench import program
from gpubench.reference import judge
from gpubench.reference import problem as ref_problem
from gpubench.traffic.scan import make_scan


class FitPool:
    """An entry over a pool of scans; subclasses give ``fit`` (the program's
    call), ``reference`` (the reference's answers) and ``predict``."""

    m = 3                 # parameters a texel (and channel) of the compared fit

    def __init__(self, cell, seed: int, device):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device = seed, device
        self.pool = int(self.traffic["pool"])
        self.ref_cache = {}

    def setup(self) -> None:
        program.build_kernels(self.device)
        self.scans = [make_scan(self.config, self.seed, k, device=self.device)
                      for k in range(self.pool)]
        self.problems = [program.problem(self.config, program.scene(s)) for s in self.scans]
        width = self.config["scan"]["width"]
        self.keys = [program.texel_keys(self.config, p, width) for p in self.problems]
        self.opts = program.lm_options(self.config)
        for k in range(self.pool):
            for _ in range(int(self.traffic.get("warm_calls", 2))):
                self.fit(self.problems[k])

    def request(self, i: int):
        k = i % self.pool
        params, chi2 = self.fit(self.problems[k])
        return len(self.keys[k]), (k, params, chi2)

    def release(self) -> None:
        """Drop the program's state; the scans and the texel keys stay."""
        self.problems = None

    # -- the check ------------------------------------------------------------

    def reference_problem(self, k: int):
        if k not in self.ref_cache:
            self.ref_cache[k] = ref_problem.build(self.scans[k], self.config)
        return self.ref_cache[k]

    def judge(self, samples, answers=None, detail: bool = False) -> dict:
        """The check's numbers over ``samples`` (the requests kept from the
        window), each the worst over them; ``answers(k)`` puts other answers
        for scan ``k`` in the program's place (the control)."""
        out = {"detail": []} if detail else {}
        for k, params, chi2 in samples:
            prob = self.reference_problem(k)
            if ("fit", k) not in self.ref_cache:
                self.ref_cache["fit", k] = self.reference(prob, torch.float64)[0]
            keys = self.keys[k]
            if answers is not None:
                keys = prob.keys
                params, chi2 = answers(k)
            y, w = self.observed(prob)
            nums = judge.fit_numbers(lambda p, rows: self.predict(prob, p, rows), y, w,
                                     self.ref_cache["fit", k],
                                     prob.keys, keys, params, chi2, self.m,
                                     float(self.traffic["check"]["tau"]), detail)
            if detail:
                out["detail"].append(nums.pop("detail"))
            for name, value in nums.items():
                out[name] = max(out.get(name, value), value)
        return out

    def control(self, k: int, dtype=torch.bfloat16):
        """The reference in the program's place, computed in ``dtype``."""
        p, chi2 = self.reference(self.reference_problem(k), dtype)
        return p.double().cpu().numpy(), chi2.double().cpu().numpy()

    def diagnose(self, k: int, params, chi2, stop, iters) -> dict:
        """Where the program's answers for scan ``k`` are worse than the
        reference's by more than tau: the solver's stop reasons and
        iterations there and everywhere, and both sides' RMS residuals."""
        prob = self.reference_problem(k)
        if ("fit", k) not in self.ref_cache:
            self.ref_cache["fit", k] = self.reference(prob, torch.float64)[0]
        idx, ok, _ = judge.match(prob.keys, self.keys[k])
        rows = torch.as_tensor(idx[ok], device=self.device)
        y, w = self.observed(prob)
        y, w = y[rows], w[rows]
        pp = torch.as_tensor(np.asarray(params)[ok], device=self.device, dtype=torch.float64)
        n = (w > 0).sum(-1)

        def rms(p):
            return torch.sqrt(((w * (self.predict(prob, p, rows) - y)) ** 2).sum(-1)
                              / torch.clamp(n, min=1)).cpu().numpy()

        r_prog, r_ref = rms(pp), rms(self.ref_cache["fit", k][rows])
        worse = ((r_prog - r_ref) > float(self.traffic["check"]["tau"])) \
            & (n.cpu().numpy() >= self.m + 1)
        st, it = np.asarray(stop)[ok], np.asarray(iters)[ok]

        def hist(x):
            vals, counts = np.unique(x, return_counts=True)
            return {str(int(v)): int(c) for v, c in zip(vals, counts)}

        q = [0.1, 0.5, 0.9]
        return {"worse": int(worse.sum()), "all": int(worse.size),
                "stop_worse": hist(st[worse]), "stop_all": hist(st),
                "iters_worse_q": np.quantile(it[worse], q).tolist() if worse.any() else [],
                "iters_all_q": np.quantile(it, q).tolist(),
                "rms_prog_worse_q": np.quantile(r_prog[worse], q).tolist() if worse.any() else [],
                "rms_ref_worse_q": np.quantile(r_ref[worse], q).tolist() if worse.any() else []}

