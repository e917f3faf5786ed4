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
    for kw in (dict(), dict(use_vertex_normals=False), dict(normal_offsets=offsets)):
        got = t_render.gather_covered_pixels(ts.mesh, ts.raster_map(0), params[faces], faces, **kw)
        ref = j_render.gather_covered_pixels(js.mesh, js.raster_map(0), params[faces], faces, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
        assert not got[4].all() and got[4].any()


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance_aniso"])
def test_render_image_matches_jax(model):
    js, ts, params = make_scene(model)
    faces = np.arange(js.mesh.num_faces)
    for kw in (dict(view=0), dict(view=7, use_vertex_normals=False, background=0.25)):
        got = t_render.render_image(model, ts, params, faces, device="cpu", **kw)
        ref = j_render.render_image(model, js, params, faces, **kw)
        assert got.shape == (72, 96, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    cov = ts.raster_map(0).coverage
    assert 0.05 < cov.mean() < 0.6 and got[cov].max() > 0.01 and (got[~cov] == 0.25).all()


def test_render_image_with_normal_offsets():
    js, ts, params = make_scene(seed=2)
    t = js.mesh.num_faces
    faces = np.arange(t)
    flat = t_render.render_image("blinn_phong", ts, params, faces, use_vertex_normals=False,
                                 device="cpu")
    offsets = np.full((t, 2), 0.3, np.float32)
    got = t_render.render_image("blinn_phong", ts, params, faces, normal_offsets=offsets,
                                device="cpu")
    ref = j_render.render_image("blinn_phong", js, params, faces, normal_offsets=offsets)
    # the tangent frame is float32 on the JAX side and float64 on this one
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    cov = ts.raster_map(0).coverage
    assert np.abs(flat[cov] - got[cov]).mean() > 1e-3
    zero = t_render.render_image("blinn_phong", ts, params, faces,
                                 normal_offsets=np.zeros((t, 2), np.float32), device="cpu")
    np.testing.assert_allclose(zero[cov], flat[cov], atol=1e-5)


# A GGX highlight at roughness 0.15 turns one ulp of N·H into 1e-4 of the
# intensity (D ~ 1/(1 − nh²(1 − α⁴))² next to nh = 1), and the two frameworks
# round the normalised half vector differently; a few pixels of a relit
# sphere sit on such a highlight.
GGX_RTOL = 5e-4


@pytest.mark.parametrize("model,rtol", [("blinn_phong", RTOL), ("cook_torrance", GGX_RTOL)])
def test_relight_matches_jax_and_changes_the_image(model, rtol):
    js, ts, params = make_scene(model)
    faces = np.arange(js.mesh.num_faces)
    imgs = []
    for lights in (js.lights, np.asarray([[300.0, 150.0, 300.0]]), np.asarray([[-300.0, 150.0, 300.0]])):
        got = t_render.relight(model, ts, params, faces, lights=lights, device="cpu")
        ref = j_render.relight(model, js, params, faces, lights=lights)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=ATOL)
        imgs.append(got)
    cov = ts.raster_map(0).coverage
    assert np.abs(imgs[1][cov] - imgs[2][cov]).mean() > 1e-3
    assert imgs[0][cov].mean() > imgs[1][cov].mean()                  # 16 lights against one


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
def test_render_turntable_matches_jax(headlight):
    js, ts, params = make_scene()
    faces = np.arange(js.mesh.num_faces)
    got = t_render.render_turntable("blinn_phong", ts, params, faces, frames=2, size=(64, 64),
                                    headlight=headlight, device="cpu")
    ref = j_render.render_turntable("blinn_phong", js, params, faces, frames=2, size=(64, 64),
                                    headlight=headlight)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    for frame in got:
        assert (frame.max(-1) > 0.01).mean() > 0.02       # the object is visible and lit
    assert np.abs(got[0] - got[1]).max() > 0.01           # the viewpoint moved


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
