"""The port's spans and counters (brdf_tpu_torch/utils/profiling.py) on the
CPU: off by default and then leaving nothing behind, the spans of the fit
entries, the eager LM loop, the eager LM solver (``levmar_bc``), the gain
rounds of the joint fit and the relight path with their parents, request
ids and counts when on, their clock against ``torch.profiler``'s, results
bit-identical either way, and the operator's exporter (``fit --profile``).

The scene is tools/synthetic_scene.py's bumped sphere (320 faces, 80 × 60,
16 LED views), rendered in memory with the port's own renderer."""

import json

import numpy as np
import pytest
import torch

from brdf_tpu_torch.geometry import Camera, TriangleMesh
from brdf_tpu_torch.io import led_rig_positions
from brdf_tpu_torch.ops import ne
from brdf_tpu_torch.pipeline import scene as t_scene
from brdf_tpu_torch.pipeline.fit import (
    build_face_problem,
    fit_joint_normalmap,
    fit_joint_normalmap_with_gains,
    fit_per_texel,
)
from brdf_tpu_torch.pipeline.render import relight, render_image
from brdf_tpu_torch.pipeline.scene import Scene
from brdf_tpu_torch.solver.lm import LMOptions, levmar_bc
from brdf_tpu_torch.utils import profiling
from tools.synthetic_scene import (
    CENTER,
    EYE,
    RADIUS,
    VIEWS,
    bumped_sphere,
    face_params,
    write_scene,
)

MODEL = "cook_torrance"
NAMES = {"fit", "fit.upload", "fit.init", "fit.solve", "fit.reweight", "lm.solve", "lm.pass",
         "problem.build", "relight", "render.raster_map", "render.gather", "render.shade",
         "render.scatter", "levmar.solve", "levmar.iter", "fit.gains"}
JOINT_OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=6)
LIGHT = np.array([[120.0, 210.0, 280.0]])


@pytest.fixture(autouse=True)
def recording_off(monkeypatch, tmp_path):
    """Every test starts and ends with recording off and nothing recorded,
    and keeps raster maps in memory only."""
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, "")
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _scene(width=80, height=60, subdiv=2):
    verts, faces = bumped_sphere(subdiv)
    mesh = TriangleMesh.from_arrays(verts.astype(np.float32), faces)
    cam = Camera.look_at(EYE, CENTER, up=(0.0, 1.0, 0.0),
                         f=0.3 * height * (EYE[2] - CENTER[2]) / RADIUS, width=width,
                         height=height)
    lights = led_rig_positions()[:VIEWS]
    blank = Scene(mesh=mesh, cameras=[cam] * VIEWS, lights=lights,
                  images=np.zeros((VIEWS, height, width, 3), np.float32))
    params = face_params(MODEL, mesh.num_faces, np.random.default_rng(0))
    faces_all = np.arange(mesh.num_faces)
    images = np.stack([render_image(MODEL, blank, params, faces_all, view=v,
                                    use_vertex_normals=False, device="cpu")
                       for v in range(VIEWS)])
    return Scene(mesh=mesh, cameras=[cam] * VIEWS, lights=lights, images=images), params


@pytest.fixture(scope="module")
def scan():
    scene, params = _scene()
    return scene, params, build_face_problem(scene, with_geometry=True)


def _fit(problem, kind):
    """One call of the entry a benchmark cell runs, on the CPU: the result's
    tensors."""
    if kind == "joint":
        res, _ = fit_joint_normalmap(problem, MODEL, opts=JOINT_OPTS, engine="pallas",
                                     device="cpu", robust="huber", robust_iters=2)
        return tuple(res)
    report = fit_per_texel(problem, MODEL, engine=kind, device="cpu", robust="huber",
                           robust_iters=2)
    return (report.params,) + tuple(report.result)


def _relight(scene, params):
    return relight(MODEL, scene, params, np.arange(scene.mesh.num_faces), LIGHT, device="cpu")


def _by_id():
    return {s.id: s for s in profiling.records()}


def _names_under(parent, spans):
    return sorted(s.name for s in spans if s.parent == parent.id)


def test_span_is_one_null_context_while_off():
    a = profiling.span("fit", texels=3)
    b = profiling.span("lm.pass")
    assert a is b and not profiling.enabled()
    with a as sp:
        sp.set(bytes=1)
    profiling.count("lm.lanes", 5)
    assert profiling.records() == [] and profiling.counters() == {}


def test_recording_off_leaves_no_records_and_no_profiler_events(scan):
    scene, params, problem = scan
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fit(problem, "varpro")
        _relight(scene, params)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & NAMES
    assert profiling.records() == [] and profiling.counters() == {}


@pytest.mark.parametrize("engine", ["varpro", "pallas"])
def test_fit_per_texel_spans(scan, engine):
    _, _, problem = scan
    profiling.enable()
    _fit(problem, engine)
    spans = profiling.records()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["fit"]
    root = roots[0]
    t, v, c = problem.intensity.shape
    assert root.attrs == {"texels": t, "views": v, "channels": c, "engine": engine}
    assert {s.request for s in spans} == {root.request}
    init = ["fit.init"] if engine == "pallas" else []      # K1 inits in the kernel
    assert _names_under(root, spans) == sorted(
        ["fit.upload"] + init + ["fit.solve"] * 3 + ["fit.reweight"] * 2)
    upload = next(s for s in spans if s.name == "fit.upload")
    assert upload.attrs["bytes"] == sum(int(np.asarray(a).nbytes) for a in
                                        (*problem.angles, problem.intensity, problem.weights)
                                        if a is not None)
    assert [s.attrs["round"] for s in spans if s.name == "fit.solve"] == [0, 1, 2]
    assert [s.attrs["round"] for s in spans if s.name == "fit.reweight"] == [1, 2]
    assert all(s.end_ns >= s.start_ns for s in spans)
    # the chunked tier's loop is not on these paths (K1 and K5 fuse their loops)
    assert not {"lm.solve", "lm.pass"} & {s.name for s in spans}


def _rounds(spans):
    """The (name, round) of the fit's own solves and reweightings, in order."""
    root = next(s for s in spans if s.parent is None)
    return [(s.name, s.attrs["round"]) for s in spans
            if s.parent == root.id and s.name in ("fit.solve", "fit.reweight")]


@pytest.mark.parametrize("engine", ["pallas", "varpro"])
def test_a_checkpointed_robust_fit_records_the_rounds_of_the_unchunked_one(
        scan, tmp_path, engine):
    """With a checkpointer the fit's rounds are the unchunked fit's spans,
    round 0's solve holding the chunks; the parameters are those of the
    checkpointed fit followed by refits from each round's parameters."""
    from brdf_tpu_torch.pipeline import fit as pfit
    from brdf_tpu_torch.solver.robust import robust_weights, saturation_weights
    from brdf_tpu_torch.utils.checkpoint import FitCheckpointer

    _, _, problem = scan
    opts = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=12)
    kw = dict(engine=engine, device="cpu", opts=opts, robust="huber", robust_iters=2)
    profiling.enable()
    fit_per_texel(problem, MODEL, **kw)
    whole = _rounds(profiling.records())
    profiling.reset()
    chunked = fit_per_texel(problem, MODEL, checkpointer=FitCheckpointer(str(tmp_path / "a")),
                            chunk_iters=6, **kw)
    assert _rounds(profiling.records()) == whole == [
        ("fit.solve", 0), ("fit.reweight", 1), ("fit.solve", 1), ("fit.reweight", 2),
        ("fit.solve", 2)]
    profiling.enable(False)

    # the same fit written out: the checkpointed solve, then two refits
    t, v, c = problem.intensity.shape
    ang = type(problem.angles)(*(None if a is None else torch.as_tensor(a).repeat_interleave(c, 0)
                                 for a in problem.angles))
    target = torch.as_tensor(problem.intensity).permute(0, 2, 1).reshape(t * c, v)
    w = torch.as_tensor(problem.weights).repeat_interleave(c, 0) * saturation_weights(target)
    dev = torch.device("cpu")
    res = pfit._fit_chunked(MODEL, ang, target, dev, opts, w, engine,
                            FitCheckpointer(str(tmp_path / "b")), 6, True)
    for _ in range(2):
        w_irls = robust_weights(pfit.MODELS[MODEL].fn(res.p, ang) - target, w, kind="huber")
        res = pfit._fit_block(MODEL, ang, target, dev, None, opts=opts, weights=w_irls, p0=res.p,
                              engine=engine)
    torch.testing.assert_close(chunked.params, res.p.reshape(t, c, -1), rtol=0, atol=0)


def test_joint_fit_spans_and_the_loop_counters(scan):
    _, _, problem = scan
    profiling.enable()
    syncs = ne.LOOP_SYNCS
    _fit(problem, "joint")
    syncs = ne.LOOP_SYNCS - syncs
    spans = profiling.records()
    by_id = _by_id()
    root = spans[0]
    assert root.name == "fit" and root.parent is None and root.attrs["engine"] == "pallas"
    assert {s.request for s in spans} == {root.request}
    assert _names_under(root, spans) == sorted(
        ["fit.upload", "fit.init"] + ["fit.solve"] * 3 + ["fit.reweight"] * 2)
    solves = [s for s in spans if s.name == "lm.solve"]
    passes = [s for s in spans if s.name == "lm.pass"]
    assert len(solves) == 3 and all(by_id[s.parent].name == "fit.solve" for s in solves)
    assert all(by_id[s.parent].name == "lm.solve" for s in passes)
    assert len(passes) == syncs - len(solves) > 0
    lanes, active = (profiling.counters().get(k, 0) for k in ("lm.lanes", "lm.active_lanes"))
    assert lanes == len(passes) * len(problem.face_ids)
    assert 0 < active <= lanes


def _levmar(lanes=8, samples=12, itmax=8):
    """``levmar_bc`` on a batch of two-parameter exponential decays."""
    g = torch.Generator().manual_seed(0)
    x = torch.linspace(0.0, 1.0, samples)
    a = torch.rand(lanes, 2, generator=g) + 0.5
    y = a[:, :1] * torch.exp(-a[:, 1:] * x)

    def residual(p, d):
        return p[0] * torch.exp(-p[1] * x) - d

    return levmar_bc(residual, torch.ones(lanes, 2), [0.0, 0.0], [10.0, 10.0], data=y,
                     opts=LMOptions(itmax=itmax))


def test_levmar_records_nothing_while_off():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _levmar()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & NAMES
    assert profiling.records() == [] and profiling.counters() == {}


def test_levmar_spans_and_counters():
    off = _levmar()
    profiling.enable()
    res = _levmar()
    assert all(torch.equal(a, b) for a, b in zip(off, res))
    solve, *iters = profiling.records()
    assert solve.name == "levmar.solve" and solve.parent is None
    assert solve.attrs == {"lanes": 8, "m": 2, "n": 12, "jac_mode": "auto", "path": "eager"}
    # the lanes run in step: an outer iteration while any lane is active
    passes = int(res.iters.max())
    assert 0 < passes <= 8 and len(iters) == passes
    assert all(s.name == "levmar.iter" and s.parent == solve.id for s in iters)
    assert all(solve.start_ns <= s.start_ns <= s.end_ns <= solve.end_ns for s in iters)
    counters = profiling.counters()
    # one outer test an iteration and the last, and one inner test at least an iteration
    assert counters["levmar.syncs"] >= 2 * passes + 1
    assert counters["levmar.lanes"] == 8 * passes
    assert counters["levmar.active_lanes"] == int(res.iters.sum())
    assert 0 < counters["levmar.active_lanes"] <= counters["levmar.lanes"]


def test_joint_fit_with_gains_spans(scan):
    _, _, problem = scan
    profiling.enable()
    res, _, gains = fit_joint_normalmap_with_gains(problem, MODEL, rounds=2, opts=JOINT_OPTS,
                                                   engine="xla", device="cpu")
    spans = profiling.records()
    by_id = _by_id()
    assert [s.name for s in spans if s.parent is None] == ["fit", "fit.gains"] * 2 + ["fit"]
    assert [s.attrs for s in spans if s.name == "fit.gains"] == [
        {"round": 1, "views": VIEWS}, {"round": 2, "views": VIEWS}]
    solves = [s for s in spans if s.name == "levmar.solve"]
    assert len(solves) == 3 and all(by_id[s.parent].name == "fit.solve" for s in solves)
    assert all(s.attrs["lanes"] == len(problem.face_ids) and s.attrs["m"] == 9
               and s.attrs["n"] == 3 * VIEWS and s.attrs["path"] == "eager" for s in solves)
    iters = [s for s in spans if s.name == "levmar.iter"]
    assert 0 < len(iters) <= 3 * JOINT_OPTS.itmax
    assert all(by_id[s.parent].name == "levmar.solve" for s in iters)
    counters = profiling.counters()
    assert counters["levmar.syncs"] >= len(iters)
    assert 0 < counters["levmar.active_lanes"] <= counters["levmar.lanes"]
    assert counters["levmar.lanes"] == len(iters) * len(problem.face_ids)
    assert gains.shape == (VIEWS,) and res.p.shape == (len(problem.face_ids), 9)


def test_relight_spans(scan):
    scene, params, _ = scan
    profiling.enable()
    _relight(scene, params)
    spans = profiling.records()
    root = spans[0]
    assert root.name == "relight" and root.parent is None
    assert {s.request for s in spans} == {root.request}
    assert [s.name for s in spans[1:]] == ["render.raster_map", "render.gather", "render.shade",
                                           "render.scatter"]
    assert all(s.parent == root.id for s in spans[1:])
    gather, shade = spans[2], spans[3]
    covered = int(scene.raster_map(0).coverage.sum())
    assert gather.attrs == {"path": "host", "pixels": covered}
    assert shade.attrs == {"pixels": covered, "lights": 1}


def test_each_call_opens_a_request(scan):
    scene, params, _ = scan
    profiling.enable()
    _relight(scene, params)
    _relight(scene, params)
    roots = [s for s in profiling.records() if s.parent is None]
    assert len(roots) == 2 and roots[0].request != roots[1].request
    assert profiling.summary()["relight"]["count"] == 2


def test_raster_map_reads_miss_then_memory_then_disk(monkeypatch, tmp_path):
    scene, _ = _scene(40, 30, subdiv=1)
    profiling.enable()
    scene.raster_map(0)
    scene.raster_map(0)
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, str(tmp_path))
    scene._raster_cache.clear()
    scene.raster_map(0)              # rasterized, written to the disk tier
    scene._raster_cache.clear()
    scene.raster_map(0)              # read back from it
    hits = [s.attrs["hit"] for s in profiling.records() if s.name == "render.raster_map"]
    assert hits == ["miss", "memory", "miss", "disk"]


def test_spans_share_the_profiler_clock(scan):
    scene, params, problem = scan
    _fit(problem, "varpro")                       # warm: first calls open lazily
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fit(problem, "varpro")
        _relight(scene, params)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES:
            # an operator's range: a user annotation would be mirrored on the
            # device's timeline, where a trace reader counts it as device work
            assert not e.is_user_annotation(), e.name()
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = profiling.records()
    assert spans and sum(map(len, events.values())) == len(spans)
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        for (s0, s1), (e0, e1) in zip(mine, sorted(events[name])):
            assert abs(s0 - e0) < 1e6 and abs(s1 - e1) < 1e6, name
            assert e0 <= s0 <= s1 <= e1, name


@pytest.mark.parametrize("kind", ["varpro", "pallas", "joint", "relight"])
def test_results_are_bit_identical_with_recording_on(scan, kind):
    scene, params, problem = scan

    def run():
        if kind == "relight":
            return (torch.as_tensor(_relight(scene, params)),)
        return _fit(problem, kind)

    off = run()
    profiling.enable()
    on = run()
    assert profiling.records()
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))


def test_summary_takes_child_time_out_of_self_time():
    profiling.enable()
    with profiling.span("a"):
        with profiling.span("b"):
            pass
        with profiling.span("b") as sp:
            sp.set(k=1)
    profiling.count("n")
    profiling.count("n", 4)
    a, b1, b2 = profiling.records()
    assert b1.parent == b2.parent == a.id and b2.attrs == {"k": 1}
    assert a.start_ns <= b1.start_ns <= b1.end_ns <= b2.start_ns <= b2.end_ns <= a.end_ns
    out = profiling.summary()
    assert out["a"]["count"] == 1 and out["b"]["count"] == 2
    assert out["a"]["total_ms"] == a.ms and out["b"]["total_ms"] == b1.ms + b2.ms
    assert out["a"]["self_ms"] == pytest.approx(a.ms - b1.ms - b2.ms, abs=1e-9)
    assert out["b"]["self_ms"] == out["b"]["total_ms"]
    assert profiling.counters() == {"n": 5}
    profiling.reset()
    assert profiling.records() == [] and profiling.summary() == {} and profiling.counters() == {}


def test_spans_past_the_bound_are_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    profiling.enable()
    with profiling.span("a"):
        for _ in range(3):
            with profiling.span("b"):
                pass
    assert [s.name for s in profiling.records()] == ["a", "b"] and profiling.dropped() == 2


def test_profiler_trace_writes_the_trace_and_the_spans(tmp_path, scan):
    _, _, problem = scan
    with profiling.profiler_trace(str(tmp_path / "p")) as prof:
        assert profiling.enabled()
        _fit(problem, "pallas")
    assert prof is not None and not profiling.enabled()
    trace = json.loads((tmp_path / "p" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"fit", "fit.upload", "fit.init", "fit.solve"} <= names
    spans = json.loads((tmp_path / "p" / "spans.json").read_text())
    assert spans["spans"]["fit"]["count"] == 1 and spans["dropped"] == 0
    assert spans["spans"]["fit.solve"]["count"] == 3


def test_cmd_fit_profile_writes_the_trace(tmp_path):
    from brdf_tpu_torch import cli
    from brdf_tpu_torch.configs import FitConfig, ModelConfig, SceneConfig, SolverConfig

    scene_dir = str(tmp_path / "scene")
    write_scene(scene_dir, subdiv=1, width=40, height=30, model="blinn_phong", seed=0,
                device="cpu")
    cfg = FitConfig(scene=SceneConfig(scene_dir=scene_dir), model=ModelConfig(model="blinn_phong"),
                    solver=SolverConfig(itmax=4, engine="xla"), name="profiled")
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    prof_dir = tmp_path / "profile"
    assert cli.main(["fit", "--config", str(tmp_path / "cfg.json"), "--out", str(tmp_path / "run"),
                     "--device", "cpu", "--profile", str(prof_dir)]) == 0
    trace = json.loads((prof_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"problem.build", "fit", "fit.upload", "fit.solve"} <= names
    spans = json.loads((prof_dir / "spans.json").read_text())["spans"]
    assert spans["fit"]["count"] == 1 and spans["fit.upload"]["count"] == 1
    assert not profiling.enabled()
