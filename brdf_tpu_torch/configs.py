# Adapted from brdf_tpu/configs.py (the port imports nothing of brdf_tpu).
"""Configuration system: dataclass configs + JSON round-trip + named presets.

The JAX package's configs, field for field, so that a ``config.json``
written by either package's CLI loads in the other; ``ShardingConfig``
lays a multi-rank run's ranks out (``cli.py``, ``parallel/mesh.py``). The
presets' comments quote the JAX package's measurements on the
reference scans, not the port's. Replaces the reference's configuration-by-hard-coding (model selector at
``main.cpp:43``, LM opts/bounds at ``brdfdata.cpp:1049-1057,1107-1117``, LED
rig at ``brdfdata.cpp:683-797``, window size at ``main.cpp:22-23`` —
SURVEY.md §5) with explicit, serializable configs. The five presets mirror
the BASELINE.json benchmark ladder.
"""

from __future__ import annotations

import dataclasses
import json
import os

from brdf_tpu_torch.solver.lm import LMOptions


@dataclasses.dataclass
class SceneConfig:
    scene_dir: str
    cal_name: str | None = None       # which .cal in multi-camera scenes
    num_images: int = 16
    rig: str = "cylinder"             # LED rig variant (io.rig)
    views: list[int] | None = None    # subset of views to fit (None = all)
    subtract_dark: bool = True


@dataclasses.dataclass
class ModelConfig:
    model: str = "blinn_phong"        # registry name (models.brdf.MODELS)
    per_texel: bool = True            # per-texel vs single-material
    joint_normalmap: bool = False     # config-4 style joint fit
    max_tilt: float = 0.6
    granularity: str = "face"         # face | pixel (reference fit per pixel)
    pixel_stride: int = 1             # subsampling for pixel granularity
    reference_view: int = 0           # raster view for pixel texelization


@dataclasses.dataclass
class SolverConfig:
    itmax: int = 60
    eps1: float = 1e-7
    eps2: float = 1e-8
    eps3: float = 1e-14
    tau: float = 1e-3
    engine: str = "auto"              # auto | pallas | xla | varpro
    robust: str | None = None         # None | huber | cauchy | tukey
    robust_iters: int = 2
    mask_saturation: bool = True
    # Geometric cast-shadow masking: zero-weight (texel, light) pairs whose
    # light is occluded by other geometry (shadow maps from each LED via the
    # z-buffer rasterizer — geometry/visibility.py). The reference fit
    # shadowed pixels as if lit (brdfdata.cpp:1188-1227 has no visibility
    # term); IRLS only downweights them statistically.
    shadow_weights: bool = False
    shadow_resolution: int = 512
    # Fit one multiplicative gain per view jointly with the material (joint
    # normal-map tier): the rig's LEDs need not be equal-intensity — the
    # reference assumed they were. Measured on cup: gains spread 0.75-1.28
    # and cut joint MAE 7-9% per channel (runs/evidence_r5c_summary.json).
    fit_view_gains: bool = False
    view_gain_rounds: int = 2
    # Optional box override (None = the model's default box). The reference
    # hard-coded [0,100]³ everywhere (brdfdata.cpp:1115-1117) — unphysical
    # for normalized lobes on [0,1] radiance data, and the r3 audit showed it
    # lets the kd/ks roles swap at high roughness (kd parks at 0, ks absorbs
    # the diffuse energy). A physically-plausible box achieves the same
    # reprojection error with meaningful parameter maps.
    lower: list[float] | None = None
    upper: list[float] | None = None

    def lm_options(self) -> LMOptions:
        return LMOptions(
            tau=self.tau, eps1=self.eps1, eps2=self.eps2, eps3=self.eps3,
            itmax=self.itmax,
        )


@dataclasses.dataclass
class ShardingConfig:
    data: int | None = None           # texel-axis size (None = all devices)
    view: int = 1                     # measurement-axis size


@dataclasses.dataclass
class FitConfig:
    scene: SceneConfig
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
    checkpoint_dir: str | None = None
    log_file: str | None = None
    name: str = "fit"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FitConfig":
        raw = json.loads(text)
        return cls(
            scene=SceneConfig(**raw["scene"]),
            model=ModelConfig(**raw.get("model", {})),
            solver=SolverConfig(**raw.get("solver", {})),
            sharding=ShardingConfig(**raw.get("sharding", {})),
            checkpoint_dir=raw.get("checkpoint_dir"),
            log_file=raw.get("log_file"),
            name=raw.get("name", "fit"),
        )


# the JAX package's dataset root (brdf_tpu/configs.py), so that a preset
# names the same scene directory in both packages
_REF = os.path.join(os.sep, "root", "reference", "img")

# The BASELINE.json benchmark ladder as named presets. The separable
# per-texel presets run the VarPro engine (solver/varpro.py): measured on
# all three real scenes it matches or beats the fused-LM tier's
# reprojection error (cup -1.4..-3.3% MAE) at 2x its synthetic
# throughput (runs/evidence_r4g_summary.json; the pre-BVLS attempt that
# LOST on real scenes is kept in runs/evidence_r4g_prebvls_summary.json).
PRESETS: dict[str, FitConfig] = {
    # (1) single-material Blinn-Phong, cup, 1 view — CPU-runnable reference
    "cup-single": FitConfig(
        name="cup-single",
        scene=SceneConfig(scene_dir=f"{_REF}/cup", views=[0]),
        model=ModelConfig(model="blinn_phong", per_texel=False),
        solver=SolverConfig(itmax=300, engine="xla"),
    ),
    # (2) per-texel Blinn-Phong, timber, 4 views
    "timber-blinn": FitConfig(
        name="timber-blinn",
        scene=SceneConfig(scene_dir=f"{_REF}/timber", views=[0, 5, 10, 15]),
        model=ModelConfig(model="blinn_phong"),
        solver=SolverConfig(robust="huber", engine="varpro"),
    ),
    # (3) per-texel Cook-Torrance, bunny, all views. Plausible-reflectance
    # box: same reprojection error as [0,100]³, non-degenerate kd maps
    # (kd median 0.93/0.55/0.39 instead of 0 — see runs/bunny metrics)
    "bunny-ct": FitConfig(
        name="bunny-ct",
        scene=SceneConfig(scene_dir=f"{_REF}/bunny"),
        model=ModelConfig(model="cook_torrance"),
        solver=SolverConfig(robust="huber", engine="varpro",
                            lower=[0.0, 0.0, 1e-3], upper=[2.0, 2.0, 1.0]),
    ),
    # (4) joint normal-map + Cook-Torrance with bounded LM, bunny
    # (engine auto: the chunked m=9 Pallas tier on TPU, xla elsewhere)
    "bunny-joint": FitConfig(
        name="bunny-joint",
        scene=SceneConfig(scene_dir=f"{_REF}/bunny"),
        model=ModelConfig(model="cook_torrance", joint_normalmap=True),
        solver=SolverConfig(itmax=40, engine="auto"),
    ),
    # (5) complexScene multi-object rig + relight render
    "complex-relight": FitConfig(
        name="complex-relight",
        scene=SceneConfig(scene_dir=f"{_REF}/complexScene", cal_name="ipod.cal"),
        model=ModelConfig(model="cook_torrance"),
        solver=SolverConfig(robust="tukey", engine="varpro",
                            lower=[0.0, 0.0, 1e-3], upper=[2.0, 2.0, 1.0]),
    ),
    # ---- recommended real-scan tiers beyond the original ladder ----
    # Joint normal-map fits are the DOCUMENTED DEFAULT for real scenes:
    # per-texel fits against scanned normals park the specular params at the
    # box (bunny CT measured ks-upper 0.59 / roughness-upper 0.58, collapsing
    # to 0.03 once the normal is fit jointly — runs/bunny_tpu vs
    # runs/bunny_joint) and the joint fit cut bunny render-vs-photo MAE ~40%.
    # cup saturates 0.22/0.27 in G/B: the per-channel saturation mask (the
    # joint-tier default) + per-channel huber IRLS cut its G/B MAE 13-18%
    # (0.103/0.105/0.107 -> 0.101/0.088/0.088, runs/cup_joint_{nosat,sat,
    # sat_irls} A/B, round 5)
    "cup-joint": FitConfig(
        name="cup-joint",
        scene=SceneConfig(scene_dir=f"{_REF}/cup"),
        model=ModelConfig(model="cook_torrance", joint_normalmap=True),
        solver=SolverConfig(itmax=40, engine="auto", robust="huber"),
    ),
    "complex-joint": FitConfig(
        name="complex-joint",
        scene=SceneConfig(scene_dir=f"{_REF}/complexScene", cal_name="ipod.cal"),
        model=ModelConfig(model="cook_torrance", joint_normalmap=True),
        solver=SolverConfig(itmax=40, engine="auto"),
    ),
    # Anisotropic Ward on timber (wood = the canonical anisotropic material;
    # the m=5 tangent-frame lobes are first-class in every solver tier)
    "timber-aniso": FitConfig(
        name="timber-aniso",
        scene=SceneConfig(scene_dir=f"{_REF}/timber"),
        model=ModelConfig(model="ward_aniso"),
        solver=SolverConfig(
            robust="huber",
            lower=[0.0, 0.0, 1e-3, 1e-3, -1.5707963],
            upper=[2.0, 2.0, 1.0, 1.0, 1.5707963],
        ),
    ),
    # cup-joint + fitted per-view rig gains (the best measured cup config:
    # the fitted gains spread 0.75-1.28 — the rig's LEDs are NOT
    # equal-intensity — and absorb another 7-9% MAE per channel on top of
    # the saturation mask, runs/evidence_r5c_summary.json)
    "cup-joint-gains": FitConfig(
        name="cup-joint-gains",
        scene=SceneConfig(scene_dir=f"{_REF}/cup"),
        model=ModelConfig(model="cook_torrance", joint_normalmap=True),
        solver=SolverConfig(itmax=40, engine="auto", robust="huber",
                            fit_view_gains=True),
    ),
    # Joint normal-map + anisotropic GGX for timber (m=11: RGB kd/ks,
    # rough_x/rough_y/phi, tangent offsets) — the joint tier extended to
    # the lobes that win timber, engine xla (jacfwd through
    # perturbed_angles; the Pallas joint kernel is m=9-only). Measured
    # (round 5, runs/timber_joint_aniso): MAE 0.101/0.101/0.109 vs the
    # per-texel aniso fit's 0.115/0.121/0.131 — the TIMBER DEFAULT.
    # + fitted rig gains: the timber gain vector correlates 0.78 with
    # cup's (same LED rig — the gains are real rig properties) and cuts
    # MAE another 13-15%/channel (0.101/0.101/0.109 -> 0.087/0.086/0.095,
    # runs/timber_joint_aniso_gains)
    "timber-joint-aniso": FitConfig(
        name="timber-joint-aniso",
        scene=SceneConfig(scene_dir=f"{_REF}/timber"),
        model=ModelConfig(model="cook_torrance_aniso", joint_normalmap=True),
        solver=SolverConfig(itmax=40, engine="xla", fit_view_gains=True),
    ),
}
