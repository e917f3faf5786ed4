"""Entry ``relight``: a user dragging a light over a fitted scan. Each
request is one new point light drawn from the seed near the rig, rendered
by ``pipeline/render.py::relight`` at the scan camera from the scan's
per-face, per-channel maps; it ends with the image on the host. The check
renders each sampled request again with the reference and compares pixel
by pixel."""

from __future__ import annotations

import numpy as np
import torch

from gpubench import program
from gpubench.reference import judge
from gpubench.reference import render as ref_render
from gpubench.traffic.scan import make_scan


class Entry:
    units = "images"

    def __init__(self, cell, seed: int, device):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device = seed, device

    def light(self, i: int) -> np.ndarray:
        """Light ``i`` of the seed's stream (negative ``i``: the warm-up's)."""
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed) % 2**63, 11, i + 2**31]))
        spec = self.traffic["light"]
        az = np.deg2rad(rng.uniform(*spec["azimuth_deg"]))
        r = rng.uniform(*spec["radius"])
        return np.array([r * np.sin(az), rng.uniform(*spec["height"]), r * np.cos(az)])

    def setup(self) -> None:
        program.build_kernels(self.device)
        self.scan = make_scan(self.config, self.seed, 0, device=self.device, images=False)
        self.scene = program.scene(self.scan)
        self.face_ids = np.arange(len(self.scan.geometry.faces))
        for i in range(int(self.traffic.get("warm_calls", 3))):
            self.render(self.light(-1 - i))

    def render(self, light: np.ndarray) -> np.ndarray:
        from brdf_tpu_torch.pipeline.render import relight

        return relight(self.config["model"], self.scene, self.scan.params, self.face_ids,
                       light[None], view=self.traffic.get("view", 0), device=self.device)

    def request(self, i: int):
        light = self.light(i)
        return 1, (light, self.render(light))

    def release(self) -> None:
        self.scene = None

    def reference(self, light: np.ndarray, dtype=torch.float64) -> np.ndarray:
        return ref_render.relight(self.scan.geometry, self.config["model"], self.scan.params,
                                  light[None], self.device, dtype)

    def judge(self, samples, answers=None, detail: bool = False) -> dict:
        floor = float(self.traffic["check"]["floor"])
        gap = 0.0
        for light, img in samples:
            if answers is not None:
                img = answers(light)
            gap = max(gap, judge.image_gap(img, self.reference(light), floor))
        return {"image_gap": gap}

    def control(self, light: np.ndarray, dtype=torch.bfloat16) -> np.ndarray:
        """The reference in the program's place, its shading in ``dtype``."""
        return self.reference(light, dtype)
