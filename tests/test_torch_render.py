"""``brdf_tpu_torch.pipeline.render`` against ``brdf_tpu.pipeline.render`` on
one scene handed to both packages (``convert.from_numpy``), ``device="cpu"``:
the engine ``"pallas"`` runs K2's plain version here, as the JAX package runs
its kernel in interpret mode."""

import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.geometry import Camera as JCamera, TriangleMesh as JMesh  # noqa: E402
from brdf_tpu.geometry.primitives import icosphere  # noqa: E402
from brdf_tpu.io import led_rig_positions  # noqa: E402
from brdf_tpu.pipeline import render as j_render  # noqa: E402
from brdf_tpu.pipeline.scene import Scene as JScene  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.ops import shading as ops  # noqa: E402
from brdf_tpu_torch.pipeline import render as t_render  # noqa: E402
from brdf_tpu_torch.pipeline import scene as t_scene  # noqa: E402
from torch_port_inputs import true_params  # noqa: E402

# float32 on both sides; XLA's and torch's exp/log differ by an ulp
RTOL, ATOL = 3e-5, 1e-6


@pytest.fixture(autouse=True)
def own_cache_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("BRDF_TPU_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, str(tmp_path / "torch_cache"))


def make_scene(model="blinn_phong", subdiv=1, size=(96, 72), seed=0):
    """``tests/test_pipeline.py``'s sphere under the 16-LED rig, with
    per-face parameters from a seed; the same scene in both packages."""
    rng = np.random.default_rng(seed)
    v, f = icosphere(subdiv, radius=30.0, center=(0.0, 150.0, 120.0))
    cam = JCamera.look_at(eye=(0.0, 150.0, 320.0), target=(0.0, 150.0, 120.0), up=(0, 1, 0),
                          f=180.0, width=size[0], height=size[1])
    lights = led_rig_positions()
    js = JScene(mesh=JMesh.from_arrays(v, f), cameras=[cam] * 16, lights=lights,
                images=np.zeros((16, size[1], size[0], 3), np.float32), name="synthetic")
    t = len(f)
    params = np.stack([true_params(model, rng, t) for _ in range(3)], 1)        # (T, 3, m)
    return js, convert.from_numpy(js), params


def each_path(monkeypatch):
    """Run the loop's body on the host path (the NumPy gather and fill), then
    on the path that serves every CUDA render (``shade_device_map``), here on
    CPU tensors with ``_on_card`` patched."""
    for path in ("host", "device"):
        with monkeypatch.context() as m:
            if path == "device":
                m.setattr(t_render, "_on_card", lambda dev: True)
            yield path


def pixel_case(n=333, l=5, seed=9):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    eye = np.array([0.0, 0.0, 8.0], np.float32)
    lights = (rng.normal(size=(l, 3)) * 3 + np.array([0, 0, 6.0])).astype(np.float32)
    return pts, nrm, eye, lights, rng


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("model", ["cook_torrance", "ward_aniso", "oren_nayar"])
def test_render_pixels_matches_jax(model, engine):
    pts, nrm, eye, lights, rng = pixel_case()
    params = np.stack([true_params(model, rng, 333) for _ in range(3)], 1)
    got = t_render.render_pixels(model, params, pts, nrm, eye, lights, engine=engine, device="cpu")
    assert got.shape == (333, 3) and got.dtype == torch.float32
    for j_engine in ("xla", "pallas"):
        ref = j_render.render_pixels(model, *(jnp.asarray(x) for x in (params, pts, nrm, eye, lights)),
                                     engine=j_engine)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_render_pixels_engines_agree_and_take_tensors():
    pts, nrm, eye, lights, rng = pixel_case(n=64, l=16, seed=3)
    params = torch.tensor(rng.uniform(0.05, 0.9, (64, 3, 3)).astype(np.float32))
    args = [torch.tensor(x) for x in (pts, nrm, eye, lights)]
    a = t_render.render_pixels("cook_torrance", params, *args, engine="xla", device="cpu")
    b = t_render.render_pixels("cook_torrance", params, *args, engine="pallas", device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_render_pixels_default_engine_is_the_kernel(monkeypatch):
    assert inspect.signature(t_render.render_pixels).parameters["engine"].default == "pallas"
    calls = []
    real = t_render.shade
    monkeypatch.setattr(t_render, "shade", lambda *a: calls.append(a[0]) or real(*a))
    pts, nrm, eye, lights, rng = pixel_case(n=8, l=2)
    params = rng.uniform(0.05, 0.9, (8, 3, 3)).astype(np.float32)
    t_render.render_pixels("blinn_phong", params, pts, nrm, eye, lights, device="cpu")
    assert calls == ["blinn_phong"]
    t_render.render_pixels("blinn_phong", params, pts, nrm, eye, lights, engine="xla", device="cpu")
    assert calls == ["blinn_phong"]
    assert ops.SHADE_LAUNCHES["fwd"] == 0               # CPU tensors launch nothing


def test_render_pixels_rejects_unknown_engine():
    with pytest.raises(ValueError, match="unknown shading engine"):
        t_render.render_pixels("blinn_phong", np.zeros((4, 3, 3), np.float32),
                               np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32),
                               np.ones(3, np.float32), np.ones((2, 3), np.float32),
                               engine="Pallas", device="cpu")


def test_render_pixels_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_render.render_pixels("blinn_phong", np.zeros((4, 3, 3), np.float32),
                               np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32),
                               np.ones(3, np.float32), np.ones((2, 3), np.float32))


def test_render_pixels_is_differentiable_to_params():
    pts, nrm, eye, lights, rng = pixel_case(n=32, l=4, seed=5)
    params = torch.tensor(rng.uniform(0.1, 0.9, (32, 3, 3)).astype(np.float32), requires_grad=True)
    grads = []
    for engine in ("pallas", "xla"):
        out = t_render.render_pixels("cook_torrance", params, pts, nrm, eye, lights,
                                     engine=engine, device="cpu")
        grads.append(torch.autograd.grad(out.sum(), [params])[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=2e-4, atol=2e-4)


def test_gather_covered_pixels_equals_jax():
    js, ts, params = make_scene()
    faces = np.arange(0, js.mesh.num_faces, 2)            # half the faces have a texel
    offsets = np.random.default_rng(4).uniform(-0.3, 0.3, (len(faces), 2)).astype(np.float32)
    dmap = ts.device_map(0, "cpu")
    for kw in (dict(), dict(use_vertex_normals=False), dict(normal_offsets=offsets)):
        got = t_render.gather_covered_pixels(ts.mesh, ts.raster_map(0), params[faces], faces, **kw)
        ref = j_render.gather_covered_pixels(js.mesh, js.raster_map(0), params[faces], faces, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
        assert not got[4].all() and got[4].any()
        # the device gather, on CPU tensors, against the same reference
        on_dev = t_render.gather_on_device(dmap, params[faces], faces, **kw)
        assert np.array_equal(dmap.pixels.numpy(), np.flatnonzero(np.asarray(ref[0])))
        for g, r in zip(on_dev, ref[1:]):
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance_aniso"])
def test_render_image_matches_jax(model, monkeypatch):
    js, ts, params = make_scene(model)
    faces = np.arange(js.mesh.num_faces)
    cov = ts.raster_map(0).coverage
    for path in each_path(monkeypatch):
        for kw in (dict(view=0), dict(view=7, use_vertex_normals=False, background=0.25)):
            got = t_render.render_image(model, ts, params, faces, device="cpu", **kw)
            ref = j_render.render_image(model, js, params, faces, **kw)
            assert got.shape == (72, 96, 3) and got.dtype == np.float32, path
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=path)
        assert 0.05 < cov.mean() < 0.6 and got[cov].max() > 0.01 and (got[~cov] == 0.25).all()


def test_render_image_with_normal_offsets(monkeypatch):
    js, ts, params = make_scene(seed=2)
    t = js.mesh.num_faces
    faces = np.arange(t)
    offsets = np.full((t, 2), 0.3, np.float32)
    ref = j_render.render_image("blinn_phong", js, params, faces, normal_offsets=offsets)
    cov = ts.raster_map(0).coverage
    for path in each_path(monkeypatch):
        flat = t_render.render_image("blinn_phong", ts, params, faces, use_vertex_normals=False,
                                     device="cpu")
        got = t_render.render_image("blinn_phong", ts, params, faces, normal_offsets=offsets,
                                    device="cpu")
        # the tangent frame is float32 on the JAX side and on the device path,
        # float64 on the host path
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=path)
        assert np.abs(flat[cov] - got[cov]).mean() > 1e-3
        zero = t_render.render_image("blinn_phong", ts, params, faces,
                                     normal_offsets=np.zeros((t, 2), np.float32), device="cpu")
        np.testing.assert_allclose(zero[cov], flat[cov], atol=1e-5, err_msg=path)


# A GGX highlight at roughness 0.15 turns one ulp of N·H into 1e-4 of the
# intensity (D ~ 1/(1 − nh²(1 − α⁴))² next to nh = 1), and the two frameworks
# round the normalised half vector differently; a few pixels of a relit
# sphere sit on such a highlight.
GGX_RTOL = 5e-4


@pytest.mark.parametrize("model,rtol", [("blinn_phong", RTOL), ("cook_torrance", GGX_RTOL)])
def test_relight_matches_jax_and_changes_the_image(model, rtol, monkeypatch):
    js, ts, params = make_scene(model)
    faces = np.arange(js.mesh.num_faces)
    cov = ts.raster_map(0).coverage
    all_lights = (js.lights, np.asarray([[300.0, 150.0, 300.0]]),
                  np.asarray([[-300.0, 150.0, 300.0]]))
    refs = [j_render.relight(model, js, params, faces, lights=lights) for lights in all_lights]
    for path in each_path(monkeypatch):
        imgs = []
        for lights, ref in zip(all_lights, refs):
            got = t_render.relight(model, ts, params, faces, lights=lights, device="cpu")
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=ATOL, err_msg=path)
            imgs.append(got)
        assert np.abs(imgs[1][cov] - imgs[2][cov]).mean() > 1e-3
        assert imgs[0][cov].mean() > imgs[1][cov].mean()              # 16 lights against one


def test_orbit_cameras_equal_jax():
    js, ts, _ = make_scene()
    for kw in (dict(frames=3), dict(frames=2, elevation_deg=-10.0, distance=90.0, size=(64, 48),
                                    up=(0.0, 0.0, 1.0))):
        got, ref = t_render.orbit_cameras(ts.mesh, **kw), j_render.orbit_cameras(js.mesh, **kw)
        assert len(got) == kw["frames"]
        for g, r in zip(got, ref):
            for name, x, y in zip(g._fields, g, r):
                assert np.array_equal(np.asarray(x), np.asarray(y)), name


@pytest.mark.parametrize("headlight", [True, False])
def test_render_turntable_matches_jax(headlight, monkeypatch):
    js, ts, params = make_scene()
    faces = np.arange(js.mesh.num_faces)
    ref = j_render.render_turntable("blinn_phong", js, params, faces, frames=2, size=(64, 64),
                                    headlight=headlight)
    for path in each_path(monkeypatch):
        got = t_render.render_turntable("blinn_phong", ts, params, faces, frames=2,
                                        size=(64, 64), headlight=headlight, device="cpu")
        assert got.shape == (2, 64, 64, 3)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=path)
        for frame in got:
            assert (frame.max(-1) > 0.01).mean() > 0.02   # the object is visible and lit
        assert np.abs(got[0] - got[1]).max() > 0.01       # the viewpoint moved


def test_render_pixel_fit_matches_jax():
    from brdf_tpu.geometry.texel import pixel_texels

    js, ts, params = make_scene()
    tex = pixel_texels(js.mesh, js.raster_map(0), stride=2)
    p_tex = params[tex.face_ids]
    got = t_render.render_pixel_fit("blinn_phong", ts, p_tex, tex.pixels, tex.points, tex.normals,
                                    device="cpu")
    ref = j_render.render_pixel_fit("blinn_phong", js, p_tex, tex.pixels, tex.points, tex.normals)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert (got[tex.pixels[:, 1], tex.pixels[:, 0]].max(-1) > 0).mean() > 0.5


def test_splat_points():
    cam = convert.from_numpy(JCamera.look_at(eye=(0, 0, 10), target=(0, 0, 0), f=100.0,
                                             width=32, height=32))
    pts = np.array([[0.0, 0.0, -5.0], [0.0, 0.0, 0.0]])
    vals = np.array([[0.2, 0.2, 0.2], [0.9, 0.9, 0.9]])
    img = t_render.splat_points(cam, pts, vals)
    np.testing.assert_allclose(img[16, 15:17].max(0), 0.9, atol=1e-6)      # the nearer sample wins
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(200, 3)) * 2.0
    vals = rng.uniform(size=(200, 3))
    jcam = JCamera.look_at(eye=(0, 0, 10), target=(0, 0, 0), f=100.0, width=32, height=32)
    assert np.array_equal(t_render.splat_points(cam, pts, vals, background=0.5),
                          j_render.splat_points(jcam, pts, vals, background=0.5))


# --- the device path (pipeline/render.py::shade_device_map) on CPU tensors,
# held to the NumPy gather and the host fill it replaces on the card

def device_case(case, t):
    """Keyword arguments and texel faces of one gather case on ``t`` faces."""
    faces = np.arange(t)
    if case == "face_normals":
        return faces, dict(use_vertex_normals=False)
    if case == "normal_offsets":
        offsets = np.random.default_rng(4).uniform(-0.3, 0.3, (t, 2)).astype(np.float32)
        return faces, dict(normal_offsets=offsets)
    if case == "face_subset":                         # the missing faces render the background
        return np.arange(0, t, 3), dict(background=0.25)
    return faces, dict()


DEVICE_CASES = ["vertex_normals", "face_normals", "normal_offsets", "face_subset"]
# normals against the host's: one float32 ulp of a unit vector's component
# (the CPU's float32 sqrt is not always correctly rounded); with offsets the
# host builds the tangent frame in float64, this path in float32
NRM_ATOL = {"normal_offsets": 1e-6}


@pytest.mark.parametrize("case", DEVICE_CASES)
def test_device_gather_equals_host_gather(case):
    _, ts, params = make_scene(seed=5)
    faces, kw = device_case(case, ts.mesh.num_faces)
    kw.pop("background", None)
    rm = ts.raster_map(0)
    cov, pts, nrm, p_px, valid = t_render.gather_covered_pixels(ts.mesh, rm, params[faces],
                                                                faces, **kw)
    dmap = ts.device_map(0, "cpu")
    d_pts, d_nrm, d_p, d_valid = t_render.gather_on_device(dmap, params[faces], faces, **kw)
    assert np.array_equal(dmap.pixels.numpy(), np.flatnonzero(cov))
    assert d_p.dtype == torch.float32 and np.array_equal(d_p.numpy(), p_px)
    assert np.array_equal(d_valid.numpy(), valid)
    assert valid.any() and (case != "face_subset" or not valid.all())
    np.testing.assert_allclose(d_pts.numpy(), pts, rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(d_nrm.numpy(), nrm, rtol=0, atol=NRM_ATOL.get(case, 1.2e-7))


@pytest.mark.parametrize("case", DEVICE_CASES)
def test_device_image_equals_host_image(case):
    _, ts, params = make_scene(seed=6)
    faces, kw = device_case(case, ts.mesh.num_faces)
    cam, rm, lights = ts.cameras[0], ts.raster_map(0), ts.lights[2:5]
    host = t_render.shade_raster_map("blinn_phong", ts.mesh, rm, cam, params[faces], faces,
                                     lights, device="cpu", **kw)
    dmap = ts.device_map(0, "cpu")
    got = t_render.shade_device_map("blinn_phong", dmap, cam, params[faces], faces, lights, **kw)
    assert got.shape == host.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-7)
    background = kw.get("background", 0.0)
    assert (got[~rm.coverage] == background).all()
    if case == "face_subset":
        missing = np.isin(rm.face_id, faces, invert=True) & rm.coverage
        assert missing.any() and (got[missing] == 0.0).all()

    # the fill alone: the same shaded values land bit for bit where the host puts them
    _, pts, nrm, p_px, valid = t_render.gather_covered_pixels(ts.mesh, rm, params[faces], faces,
                                                              **{k: v for k, v in kw.items()
                                                                 if k != "background"})
    shaded = t_render._shade_on_device("blinn_phong", p_px, pts, nrm, cam, lights, "cpu")
    img = np.full(host.shape, background, np.float32)
    img[rm.coverage] = shaded.numpy() * valid[:, None]
    filled = t_render.scatter_on_device(dmap, shaded, torch.from_numpy(valid), background)
    assert np.array_equal(filled.numpy(), img)


@pytest.fixture
def card_path(monkeypatch):
    """Render through the device path on CPU tensors, recording spans and
    counters; recording off and nothing kept afterwards."""
    from brdf_tpu_torch.utils import profiling

    monkeypatch.setattr(t_render, "_on_card", lambda dev: True)
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def test_device_relight_follows_parameter_edits(card_path):
    _, ts, params = make_scene(seed=7)
    params = params.copy()
    faces = np.arange(ts.mesh.num_faces)
    light = np.asarray([[250.0, 180.0, 300.0]])
    first = t_render.relight("blinn_phong", ts, params, faces, light, device="cpu")
    params[:, :, 0] *= 0.5                            # an edit in place, same array
    second = t_render.relight("blinn_phong", ts, params, faces, light, device="cpu")
    cov = ts.raster_map(0).coverage
    assert np.abs(first[cov] - second[cov]).max() > 1e-3
    host = t_render.shade_raster_map("blinn_phong", ts.mesh, ts.raster_map(0), ts.cameras[0],
                                     params, faces, light, device="cpu")
    np.testing.assert_allclose(second, host, rtol=1e-5, atol=1e-7)
    second[:] = -1.0                                  # the caller owns the image it got
    third = t_render.relight("blinn_phong", ts, params, faces, light, device="cpu")
    np.testing.assert_allclose(third, host, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("path", ["device", "host"])
def test_relight_closes_each_render_span_once(card_path, monkeypatch, path):
    if path == "host":
        monkeypatch.setattr(t_render, "_on_card", lambda dev: False)
    _, ts, params = make_scene(seed=8)
    faces = np.arange(ts.mesh.num_faces)
    card_path.enable()
    for _ in range(2):
        t_render.relight("blinn_phong", ts, params, faces, ts.lights[:1], device="cpu")
    spans = card_path.records()
    roots = [s for s in spans if s.name == "relight"]
    assert len(roots) == 2
    covered = int(ts.raster_map(0).coverage.sum())
    for root in roots:
        mine = [s for s in spans if s.parent == root.id]
        assert [s.name for s in mine] == ["render.raster_map", "render.gather", "render.shade",
                                          "render.scatter"]
        assert all(s.end_ns is not None for s in mine)
        assert mine[1].attrs == {"path": path, "pixels": covered}
    device = path == "device"
    assert card_path.counters() == ({"render.device_gathers": 2, "render.device_map_uploads": 1}
                                    if device else {})


def test_device_map_cache_holds_one_entry_per_camera_and_device(card_path, monkeypatch):
    _, ts, params = make_scene(seed=9)
    faces = np.arange(ts.mesh.num_faces)
    relit = lambda view: t_render.relight("blinn_phong", ts, params, faces,  # noqa: E731
                                          ts.lights[:1], view=view, device="cpu")
    relit(0)                                          # recording off: nothing counted
    assert card_path.counters() == {} and len(ts._device_maps) == 1
    card_path.enable()
    relit(0)
    relit(5)                                          # another view, the same camera object
    assert len(ts._device_maps) == 1
    assert card_path.counters() == {"render.device_gathers": 2}
    ts.cameras[3] = ts.cameras[0]._replace()          # an equal camera, another object
    relit(3)
    assert len(ts._device_maps) == 2
    assert card_path.counters()["render.device_map_uploads"] == 1
    # the mesh is held once per device, whatever the number of cameras
    assert len(ts._device_meshes) == 1
    assert ts.device_map(3, "cpu").mesh is ts.device_map(0, "cpu").mesh
    dmap = ts.device_map(0, "cpu")
    assert ts.device_map(0, torch.device("cpu")) is dmap
    assert dmap.face_id.dtype == torch.int32 and dmap.bary.dtype == torch.float32
    ts._raster_cache.clear()                          # a raster map made anew is uploaded anew
    assert ts.device_map(0, "cpu") is not dmap and len(ts._device_maps) == 2
    assert card_path.counters()["render.device_map_uploads"] == 2

    # the turntable uploads each frame's map once and keeps none of them
    frames = t_render.render_turntable("blinn_phong", ts, params, faces, frames=2, size=(48, 48),
                                       device="cpu")
    assert frames.shape == (2, 48, 48, 3) and len(ts._device_maps) == 2
    assert card_path.counters() == {"render.device_gathers": 5, "render.device_map_uploads": 4}
    monkeypatch.setattr(t_render, "_on_card", lambda dev: False)
    host = t_render.render_turntable("blinn_phong", ts, params, faces, frames=2, size=(48, 48),
                                     device="cpu")
    np.testing.assert_allclose(frames, host, rtol=1e-5, atol=1e-7)


def test_planted_half_batch_fault_reaches_the_device_path(card_path):
    """``gpubench/faults.py``'s half-batch relight fault patches
    ``_shade_on_device``: the device path shades through it too, so the
    fault blanks the second half of the covered pixels there."""
    from gpubench import faults

    _, ts, params = make_scene(seed=10)
    faces = np.arange(ts.mesh.num_faces)
    light = np.asarray([[250.0, 180.0, 300.0]])
    good = t_render.relight("blinn_phong", ts, params, faces, light, device="cpu")
    with faults.planted("relight", "half_batch"):
        bad = t_render.relight("blinn_phong", ts, params, faces, light, device="cpu")
    px = good.reshape(-1, 3)[np.flatnonzero(ts.raster_map(0).coverage)]
    got = bad.reshape(-1, 3)[np.flatnonzero(ts.raster_map(0).coverage)]
    half = len(px) // 2
    assert np.array_equal(got[:half], px[:half]) and (px[half:] > 0).any()
    assert (got[half:] == 0.0).all()
