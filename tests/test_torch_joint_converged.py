"""The joint normal-map fit of the front end's cup-joint run against the JAX
package on a written synthetic scan (tools/synthetic_scene.py: a bumped
sphere of 1280 faces, 16 LED views of 200 × 150, cast-shadow weights, the
preset's itmax 40 and two huber rounds): the chunked LM tier of both
packages (the port's through K7's plain version, the JAX package's Pallas
kernel in interpret mode) leaves the same share of the lit texels
unconverged, within 0.01: a property of the tier and the scan, not of the
port.

Run as a script, the file makes the same comparison at the size of
chip_smoke.py's front-end phase, whose joint runs are held to the JAX
package's share there less this 0.01 (some minutes, about a GiB of host
memory):

    JAX_PLATFORMS=cpu python3 -m tests.test_torch_joint_converged [OUT_JSON]

It writes the phase's cook_torrance scan (20480 faces, 16 LED views of
800 x 600, seed 7), builds its face problem (with cast-shadow weights for
cup-joint, as ``fit --shadow-weights`` does; without for cup-joint-gains),
fits it with each preset's solver settings through both packages' chunked
tiers and prints one JSON object per run, then all of them as the last
line; OUT_JSON, when given, gets the same."""

import json
import os
import sys
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.pipeline import fit as j_fit  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions  # noqa: E402
from brdf_tpu_torch.configs import PRESETS  # noqa: E402
from brdf_tpu_torch.pipeline import scene as t_scene  # noqa: E402
from brdf_tpu_torch.pipeline import fit as t_fit  # noqa: E402
from brdf_tpu_torch.pipeline.fit import build_face_problem, fit_joint_normalmap  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402
from tools.synthetic_scene import write_scene  # noqa: E402

OPTS = dict(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=40)     # the cup-joint preset's


def lit_converged(stop: np.ndarray, weights: np.ndarray, intensity: np.ndarray) -> float:
    """chip_smoke.py::lit_converged for the joint fit: the share of texels
    seen lit in at least four views whose fit converged (stop 1, 2 or 6)."""
    lit = ((weights > 0) & (intensity.max(-1) > 0.02)).sum(-1) >= 4
    return float(np.isin(stop[lit], (1, 2, 6)).mean())


def test_joint_converged_share_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, str(tmp_path / "cache"))
    write_scene(str(tmp_path / "scene"), subdiv=3, width=200, height=150, model="cook_torrance",
                seed=7, device="cpu")
    prob = build_face_problem(t_scene.load_reference_scene(str(tmp_path / "scene")),
                              with_geometry=True, shadow_weights=True)
    res, _ = fit_joint_normalmap(prob, "cook_torrance", opts=LMOptions(**OPTS), engine="pallas",
                                 device="cpu", robust="huber", robust_iters=2)
    jprob = j_fit.TexelProblem(angles=jax.tree.map(jnp.asarray, prob.angles),
                               intensity=prob.intensity, weights=prob.weights,
                               face_ids=prob.face_ids,
                               geometry=jax.tree.map(jnp.asarray, prob.geometry))
    ref, _ = j_fit.fit_joint_normalmap(jprob, "cook_torrance", opts=JOptions(**OPTS),
                                       engine="pallas", robust="huber", robust_iters=2)
    got = lit_converged(res.stop.numpy(), prob.weights, prob.intensity)
    want = lit_converged(np.asarray(ref.stop), prob.weights, prob.intensity)
    assert abs(got - want) <= 0.01, (got, want)
    assert got > 0.95 and want > 0.95
    assert np.median(res.chi2.numpy()) < 2 * np.median(np.asarray(ref.chi2))


PHASE_SCAN = dict(subdiv=5, width=800, height=600, model="cook_torrance", seed=7)  # chip_smoke.py's
PHASE_RUNS = {"cup-joint-shadows": ("cup-joint", True), "cup-joint-gains": ("cup-joint-gains", False)}


def _fit_both(problem, preset: str) -> dict:
    """The preset's joint fit through the port (K7's plain version) and the
    JAX package (its Pallas kernel in interpret mode): shares and stops."""
    cfg = PRESETS[preset]
    solver = cfg.solver
    kw = dict(max_tilt=cfg.model.max_tilt, engine="pallas", robust=solver.robust,
              robust_iters=solver.robust_iters, mask_saturation=solver.mask_saturation)
    jprob = j_fit.TexelProblem(angles=jax.tree.map(jnp.asarray, problem.angles),
                               intensity=problem.intensity, weights=problem.weights,
                               face_ids=problem.face_ids,
                               geometry=jax.tree.map(jnp.asarray, problem.geometry))
    jopts = JOptions(tau=solver.tau, eps1=solver.eps1, eps2=solver.eps2, eps3=solver.eps3,
                     itmax=solver.itmax)
    if solver.fit_view_gains:
        runs = {"torch": lambda: t_fit.fit_joint_normalmap_with_gains(
                    problem, cfg.model.model, rounds=solver.view_gain_rounds,
                    opts=solver.lm_options(), device="cpu", **kw),
                "jax": lambda: j_fit.fit_joint_normalmap_with_gains(
                    jprob, cfg.model.model, rounds=solver.view_gain_rounds, opts=jopts, **kw)}
    else:
        runs = {"torch": lambda: fit_joint_normalmap(
                    problem, cfg.model.model, opts=solver.lm_options(), device="cpu", **kw),
                "jax": lambda: j_fit.fit_joint_normalmap(jprob, cfg.model.model, opts=jopts, **kw)}
    row = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        res = run()[0]
        stop, chi2 = np.asarray(res.stop), np.asarray(res.chi2)
        row[name] = dict(lit_converged=lit_converged(stop, problem.weights, problem.intensity),
                         converged=float(np.isin(stop, (1, 2, 6)).mean()),
                         chi2_median=float(np.median(chi2)),
                         stops={int(s): int((stop == s).sum()) for s in np.unique(stop)},
                         cpu_s=time.perf_counter() - t0)
    return row


def phase_size_witness(out_json: str | None = None) -> dict:
    out = {"scene": dict(faces=20 * 4 ** PHASE_SCAN["subdiv"], width=PHASE_SCAN["width"],
                         height=PHASE_SCAN["height"], views=16, seed=PHASE_SCAN["seed"])}
    with tempfile.TemporaryDirectory() as work:
        os.environ[t_scene.CACHE_DIR_ENV] = os.path.join(work, "cache")
        write_scene(os.path.join(work, "scene"), device="cpu", **PHASE_SCAN)
        scene = t_scene.load_reference_scene(os.path.join(work, "scene"))
        for run, (preset, shadows) in PHASE_RUNS.items():
            problem = build_face_problem(scene, with_geometry=True, shadow_weights=shadows,
                                         shadow_resolution=PRESETS[preset].solver.shadow_resolution)
            out[run] = dict(preset=preset, shadow_weights=shadows,
                            texels=len(problem.face_ids), **_fit_both(problem, preset))
            print(json.dumps({run: out[run]}), flush=True)
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    phase_size_witness(sys.argv[1] if len(sys.argv) > 1 else None)
