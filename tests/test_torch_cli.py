"""The port's front end (``python -m brdf_tpu_torch``, brdf_tpu_torch/cli.py
and configs.py) against the JAX package's CLI on one synthetic scan in the
layout of the reference datasets (tools/synthetic_scene.py: a bumped
icosphere of 320 faces, 16 LED images of 80 × 60, a dark frame, a Tsai
``.cal``), with ``--device cpu``.

The four flows of tests/test_utils_cli.py:72-248 (which read an absent real
scan) run through both CLIs: fit → render → relight under an environment →
export with the quality audit; export with coverage and residual, and
``render --watch``; the joint fit with view gains; the single-material fit
with the audit. The JAX CLI runs in a subprocess of its own (as
test_utils_cli.py runs it), the port's in this process. At four views a
texel's parameters are not identified (most texels see the light in fewer
than four of them), so the two CLIs' per-texel and joint fits land at
different points of the same valley and are compared by outcome, as
tests/test_torch_joint_fit.py compares its fits: the saved χ² row by row, the
audit's reprojection error, the fitted view gains (that file's 0.05); the
single material, which is identified, to 1e-3. A run directory written by
either CLI renders in the other."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from brdf_tpu_torch import cli  # noqa: E402
from brdf_tpu_torch.configs import (  # noqa: E402
    PRESETS,
    FitConfig,
    ModelConfig,
    SceneConfig,
    SolverConfig,
)
from brdf_tpu_torch.pipeline import scene as t_scene  # noqa: E402
from brdf_tpu_torch.utils.checkpoint import load_fit_state, save_fit_state  # noqa: E402
from tools.synthetic_scene import write_scene  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the four flows: config, then each CLI's commands after the fit (the JAX
# CLI runs the same commands without --device)
FLOWS = {
    "smoke": (dict(views=[0, 5, 10, 15]), ModelConfig(model="blinn_phong"),
              SolverConfig(itmax=8, engine="xla"),
              [["render", "--view", "0"],
               ["relight", "--view", "0", "--env", "constant:1.0", "--env-samples", "128",
                "--out", "{run}/env.png"],
               ["export", "--stats"]]),
    "watch": (dict(views=[0]), ModelConfig(model="blinn_phong"),
              SolverConfig(itmax=4, engine="xla"),
              [["export", "--coverage"], ["export", "--residual"]]),
    "gains": (dict(views=[0, 5, 10, 15]), ModelConfig(model="cook_torrance", joint_normalmap=True),
              SolverConfig(itmax=4, engine="xla", fit_view_gains=True, view_gain_rounds=1),
              [["export", "--stats", "--residual"],
               ["render", "--view", "0", "--out", "{run}/scan.png"],
               ["render", "--view", "0", "--light", "300,150,300", "--out", "{run}/custom.png"]]),
    "single": (dict(views=[0, 5, 10, 15]), ModelConfig(model="blinn_phong", per_texel=False),
               SolverConfig(itmax=20, engine="xla"),
               [["export", "--stats"]]),
}

JAX_SCRIPT = """
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
from brdf_tpu.cli import main
work = sys.argv[1]
plan = json.load(open(os.path.join(work, "plan.json")))
for name, commands in plan["flows"].items():
    run = os.path.join(work, "jax", name)
    assert main(["fit", "--config", os.path.join(work, name + ".json"), "--out", run]) == 0
    for argv in commands:
        assert main([a.replace("{run}", run) for a in argv] + ["--run", run]) == 0
# each run rendered by the JAX CLI: its own, and the port's
for name in plan["flows"]:
    for pkg, png in (("jax", "own.png"), ("torch", "by_jax.png")):
        run = os.path.join(work, pkg, name)
        assert main(["render", "--run", run, "--view", "0", "--out", os.path.join(run, png)]) == 0
print("PASS")
"""


def _config(scene_dir: str, name: str) -> FitConfig:
    views, model, solver, _ = FLOWS[name]
    return FitConfig(scene=SceneConfig(scene_dir=scene_dir, **views), model=model, solver=solver,
                     name=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every flow through both CLIs on one written scene; returns the work
    directory (``jax/<flow>``, ``torch/<flow>``)."""
    work = tmp_path_factory.mktemp("cli")
    patch = pytest.MonkeyPatch()
    patch.setenv(t_scene.CACHE_DIR_ENV, str(work / "raster_cache"))
    scene_dir = str(work / "scene")
    write_scene(scene_dir, subdiv=2, width=80, height=60, model="cook_torrance", seed=0,
                device="cpu")
    for name in FLOWS:
        (work / f"{name}.json").write_text(_config(scene_dir, name).to_json())
    (work / "plan.json").write_text(json.dumps({"flows": {k: v[3] for k, v in FLOWS.items()}}))
    for name, (_, _, _, commands) in FLOWS.items():
        run = str(work / "torch" / name)
        assert cli.main(["fit", "--config", str(work / f"{name}.json"), "--out", run,
                         "--device", "cpu"]) == 0
        for argv in commands:
            assert cli.main([a.replace("{run}", run) for a in argv]
                            + ["--run", run, "--device", "cpu"]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", BRDF_TPU_CACHE_DIR=str(work / "jax_raster_cache"),
               JAX_CACHE_DIR=str(work / "jax_compile_cache"))
    out = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(work)], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0 and "PASS" in out.stdout, out.stderr[-3000:]
    yield work
    patch.undo()


def _arrays(work, pkg, name):
    return load_fit_state(str(work / pkg / name))


def _events(run) -> list:
    return [json.loads(line) for line in open(os.path.join(run, "events.jsonl"))]


def test_fit_render_relight_export(runs):
    """test_utils_cli.py::test_cli_fit_and_render_smoke: the per-texel fit's
    χ² agrees with the JAX CLI's to 1e-2 (atol 1e-6) on 95% of the (texel,
    channel) rows (measured 0.99), its reprojection error within 5% and its
    converged share within 0.05 (test_torch_fit.py's bar for this tier); the
    maps, the audit and the events are those of the JAX run."""
    (aj, mj), (at, mt) = _arrays(runs, "jax", "smoke"), _arrays(runs, "torch", "smoke")
    assert mt["mode"] == mj["mode"] == "per_texel" and mt["config"] == mj["config"]
    assert set(at) == set(aj) and at["params"].shape == aj["params"].shape
    np.testing.assert_array_equal(at["face_ids"], aj["face_ids"])
    assert np.isclose(at["chi2"], aj["chi2"], rtol=1e-2, atol=1e-6).mean() >= 0.95
    run_t, run_j = runs / "torch" / "smoke", runs / "jax" / "smoke"
    done = {pkg: next(e for e in _events(r) if e["kind"] == "fit_done")
            for pkg, r in (("torch", run_t), ("jax", run_j))}
    assert abs(done["torch"]["converged"] - done["jax"]["converged"]) <= 0.05
    kinds = [e["kind"] for e in _events(run_t)]
    for kind in ("scene_loaded", "device_ready", "problem_built", "fit_done", "saved"):
        assert kind in kinds
    for png in ("render_view0.png", "env.png", "maps/param_kd.png", "maps/param_n.png"):
        assert (run_t / png).exists(), png
    s = json.load(open(run_t / "maps" / "summary.json"))
    assert s["model"] == "blinn_phong" and "kd" in s and "n" in s
    m = json.load(open(run_t / "maps" / "metrics.json"))
    mj_ = json.load(open(run_j / "maps" / "metrics.json"))
    assert set(m) == set(mj_) and len(m["reprojection_mae"]) == 3
    np.testing.assert_allclose(m["reprojection_mae"], mj_["reprojection_mae"], rtol=0.05)
    # the relit image under a constant environment, and the scan render
    for png in ("env.png", "render_view0.png"):
        it = np.asarray(Image.open(run_t / png), np.float64)
        ij = np.asarray(Image.open(run_j / png), np.float64)
        assert it.shape == ij.shape == (60, 80, 3)
        assert np.abs(it - ij).mean() < 2.0, png          # 8-bit levels


def test_export_coverage_residual_and_render_watch(runs):
    """test_utils_cli.py::test_cli_export_coverage_and_render_watch: the
    coverage overlay equals the JAX CLI's (the same raster map and photo),
    the residual summary has its keys, and ``render --watch`` re-renders when
    the run's fit state advances."""
    run_t, run_j = runs / "torch" / "watch", runs / "jax" / "watch"
    cov_t = np.asarray(Image.open(run_t / "maps" / "coverage_view0.png"))
    cov_j = np.asarray(Image.open(run_j / "maps" / "coverage_view0.png"))
    np.testing.assert_array_equal(cov_t, cov_j)
    assert (run_t / "maps" / "residual_view0.png").exists()
    s = json.load(open(run_t / "maps" / "summary.json"))
    assert "residual" in s and "positive_fraction" in s["residual"]

    png = run_t / "render_view0.png"
    argv = ["render", "--run", str(run_t), "--watch", "--watch-interval", "0.3",
            "--watch-count", "20", "--device", "cpu"]
    t = threading.Thread(target=cli.main, args=(argv,))
    t.start()
    for _ in range(100):
        if png.exists():
            break
        time.sleep(0.1)
    m0 = os.path.getmtime(png)
    time.sleep(0.5)
    arrays, meta = load_fit_state(str(run_t))
    save_fit_state(str(run_t), 1, arrays, metadata=meta)    # the fit state advances
    t.join(timeout=60)
    assert not t.is_alive()
    assert os.path.getmtime(png) > m0, "the watch loop must have re-rendered"


def test_joint_view_gains(runs):
    """test_utils_cli.py::test_cli_joint_view_gains_end_to_end: gains are
    fitted, saved, audited and applied to the scan-view render only. The
    gains are the JAX CLI's within 0.05 (test_torch_joint_fit.py's bar); the
    fit, four LM iterations from the grid init, reaches a median χ² within a
    factor 2 of the JAX CLI's and a reprojection error within 20% of it
    (measured 0.90× and 0.90–0.96×)."""
    (aj, _), (at, mt) = _arrays(runs, "jax", "gains"), _arrays(runs, "torch", "gains")
    assert mt["mode"] == "joint" and at["joint_params"].shape == aj["joint_params"].shape
    np.testing.assert_allclose(at["view_gains"], aj["view_gains"], atol=0.05)
    ratio = float(np.median(at["chi2"]) / np.median(aj["chi2"]))
    assert 0.5 < ratio < 2.0, ratio
    run_t = runs / "torch" / "gains"
    m = json.load(open(run_t / "maps" / "metrics.json"))
    m_j = json.load(open(runs / "jax" / "gains" / "maps" / "metrics.json"))
    np.testing.assert_allclose(m["reprojection_mae"], m_j["reprojection_mae"], rtol=0.2)
    assert len(m["view_gains"]) == 4 and all(0.5 <= g <= 2.0 for g in m["view_gains"])
    assert np.asarray(Image.open(run_t / "scan.png")).sum() > 0
    assert np.asarray(Image.open(run_t / "custom.png")).sum() > 0
    assert (run_t / "maps" / "param_normalmap.png").exists()


def test_single_material_export_stats(runs):
    """test_utils_cli.py::test_cli_single_material_export_stats: one
    material per channel, the JAX CLI's to 1e-3, and the audit aligns the
    every-face expansion to the visible texels."""
    (aj, _), (at, mt) = _arrays(runs, "jax", "single"), _arrays(runs, "torch", "single")
    assert mt["mode"] == "single" and at["params"].shape == aj["params"].shape == (3, 3)
    np.testing.assert_allclose(at["params"], aj["params"], rtol=1e-3, atol=1e-3)
    m = json.load(open(runs / "torch" / "single" / "maps" / "metrics.json"))
    assert len(m["reprojection_mae"]) == 3


def test_runs_render_in_the_other_package(runs):
    """A run directory written by either CLI renders in the other, to the
    image the other CLI makes of it, within one 8-bit level: the JAX CLI
    rendered each run in the fixture, the port renders each here."""
    for name in FLOWS:
        for pkg, theirs in (("torch", "by_jax.png"), ("jax", "own.png")):
            run = runs / pkg / name
            out = run / "by_torch_here.png"
            assert cli.main(["render", "--run", str(run), "--view", "0", "--out", str(out),
                             "--device", "cpu"]) == 0
            ours = np.asarray(Image.open(out), np.int64)
            ref = np.asarray(Image.open(run / theirs), np.int64)
            assert ours.shape == ref.shape == (60, 80, 3) and ours.sum() > 0
            assert np.abs(ours - ref).max() <= 1, (name, pkg)


def test_configs_presets_and_info():
    """The presets list the JAX package's names, and every config round-trips
    through JSON into the other package's types; ``presets`` and ``info``
    run as a module; the multi-GPU options name their roadmap item."""
    from brdf_tpu.configs import PRESETS as J_PRESETS, FitConfig as JFitConfig

    assert list(PRESETS) == list(J_PRESETS)
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_PRESETS[name])
        assert dataclasses.asdict(JFitConfig.from_json(cfg.to_json())) == dataclasses.asdict(cfg)
        assert FitConfig.from_json(J_PRESETS[name].to_json()) == cfg
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    listing = subprocess.run([sys.executable, "-m", "brdf_tpu_torch", "presets"], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=120)
    assert listing.returncode == 0, listing.stderr
    assert [line.split()[0] for line in listing.stdout.splitlines()] == list(J_PRESETS)
    info = subprocess.run([sys.executable, "-m", "brdf_tpu_torch", "info"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert info.returncode == 0, info.stderr
    got = json.loads(info.stdout)
    assert got["torch"] == torch.__version__ and got["device_count"] == torch.cuda.device_count()
    assert (got["process_count"], got["process_index"]) == (1, 0)
    # --multihost on one process outside a cluster starts nothing and runs the command
    assert cli.main(["--multihost", "presets"]) == 0
    assert not torch.distributed.is_initialized()


def test_fit_without_device_cpu_raises_here(tmp_path):
    """No fallback hides the device: without a GPU, ``fit`` (and every command
    that computes) raises unless given ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = FitConfig(scene=SceneConfig(scene_dir=str(tmp_path)), name="nodevice")
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["fit", "--config", str(tmp_path / "cfg.json"), "--out", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["render", "--run", str(tmp_path / "run")])


def test_api_names_and_clean_imports():
    """The port exports every name the JAX package's ``__init__``,
    ``solver/__init__`` and ``parallel/__init__`` export, and a fresh
    interpreter imports the front end's modules and the mesh with no ``jax``,
    no JAX package, no PIL and no ``triton``."""
    import ast

    import brdf_tpu_torch
    import brdf_tpu_torch.solver

    for mod, init in ((brdf_tpu_torch, "brdf_tpu/__init__.py"),
                      (brdf_tpu_torch.solver, "brdf_tpu/solver/__init__.py")):
        tree = ast.parse((ROOT / init).read_text())
        names = [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                 for a in node.names]
        assert names and [n for n in names if not hasattr(mod, n)] == [], init
    import brdf_tpu_torch.parallel

    tree = ast.parse((ROOT / "brdf_tpu/parallel/__init__.py").read_text())
    names = [a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names]
    assert names and [n for n in names if not hasattr(brdf_tpu_torch.parallel, n)] == []
    code = """
import sys
for mod in ("cli", "configs", "pipeline.envlight", "parallel.mesh",
            "geometry.visibility", "utils.logging", "utils.profiling", "solver.axb",
            "solver.constrained", "solver.problems", "solver.stats"):
    __import__("brdf_tpu_torch." + mod)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "brdf_tpu", "PIL", "triton")]
assert not bad, bad
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-2000:]


def test_event_log_timer_and_throughput(tmp_path, capsys):
    """tests/test_utils_cli.py's logging case in the port, with the fit
    summary of a result and the profiler's trace file (the port has no timer
    or throughput helper: tests/test_torch_spans.py covers its spans)."""
    from brdf_tpu_torch.solver.lm import LMResult
    from brdf_tpu_torch.utils.logging import EventLog, fit_summary_event
    from brdf_tpu_torch.utils.profiling import profiler_trace

    path = tmp_path / "events.jsonl"
    log = EventLog(str(path))
    log("test_event", value=42, arr=np.arange(2), x=torch.tensor([1.5]))
    log.close()
    events = [json.loads(line) for line in open(path)]
    assert events[0]["kind"] == "test_event" and events[0]["value"] == 42
    assert events[0]["arr"] == [0, 1] and events[0]["x"] == [1.5]
    assert '"test_event"' in capsys.readouterr().out
    z = torch.zeros(4)
    res = LMResult(p=torch.zeros(4, 3), chi2=torch.tensor([1e-9, 2e-9, 1.0, 3e-9]), chi2_init=z,
                   g_inf=z, iters=torch.tensor([3, 4, 60, 5]), stop=torch.tensor([1, 2, 3, 6]),
                   nfev=z, njev=z, mu=z, nu=z, nlss=z, constraint_violation=z)
    ev = fit_summary_event(res, quiet=True)
    assert ev["n"] == 4 and ev["converged_frac"] == 0.75 and ev["stop_counts"] == {1: 1, 2: 1, 3: 1, 6: 1}
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
    assert (tmp_path / "trace" / "spans.json").exists()
    with profiler_trace(None) as prof:
        pass
    assert prof is None
