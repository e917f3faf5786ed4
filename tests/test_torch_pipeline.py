"""The closed loop scene → problem → fit → image through the port, on one
synthetic scene that the JAX package renders and ``convert.from_numpy`` hands
over (``tests/test_pipeline.py``'s scene and bars), ``device="cpu"``."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from brdf_tpu.geometry import Camera as JCamera, TriangleMesh as JMesh  # noqa: E402
from brdf_tpu.geometry.primitives import icosphere  # noqa: E402
from brdf_tpu.io import led_rig_positions  # noqa: E402
from brdf_tpu.pipeline import fit as j_fit, render as j_render  # noqa: E402
from brdf_tpu.pipeline.scene import Scene as JScene  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import ShadingAngles, ShadingGeometry  # noqa: E402
from brdf_tpu_torch.pipeline import (  # noqa: E402
    Scene,
    build_face_problem,
    build_pixel_problem,
    fit_per_texel,
    relight,
    render_image,
)
from brdf_tpu_torch.pipeline import scene as t_scene  # noqa: E402
from brdf_tpu_torch.pipeline.fit import TexelProblem, fit_quality_metrics  # noqa: E402
from brdf_tpu_torch.pipeline.render import render_pixel_fit  # noqa: E402

MODEL = "blinn_phong"


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A sphere in front of a camera under the 16-LED rig, its 16 images
    rendered by the JAX package from known per-face parameters with flat
    shading; the same scene in both packages."""
    cache = tmp_path_factory.mktemp("raster_cache")
    patch = pytest.MonkeyPatch()
    patch.setenv("BRDF_TPU_CACHE_DIR", str(cache / "jax"))
    patch.setenv(t_scene.CACHE_DIR_ENV, str(cache / "torch"))
    rng = np.random.default_rng(0)
    v, f = icosphere(2, radius=30.0, center=(0.0, 150.0, 120.0))
    cam = JCamera.look_at(eye=(0.0, 150.0, 320.0), target=(0.0, 150.0, 120.0), up=(0, 1, 0),
                          f=300.0, width=160, height=120)
    lights = led_rig_positions()
    t = len(f)
    params = np.stack([rng.uniform(0.2, 0.8, (t, 3)), rng.uniform(0.2, 0.9, (t, 3)),
                       rng.uniform(3.0, 20.0, (t, 3))], axis=-1).astype(np.float32)
    js = JScene(mesh=JMesh.from_arrays(v, f), cameras=[cam] * 16, lights=lights,
                images=np.zeros((16, 120, 160, 3), np.float32), name="synthetic")
    js.images = np.stack([
        j_render.render_image(MODEL, js, params, np.arange(t), view=vi, use_vertex_normals=False)
        for vi in range(16)]).astype(np.float32)
    ts = convert.from_numpy(js)
    yield js, ts, params
    patch.undo()


@pytest.fixture(scope="module")
def face_fit(synthetic):
    _, ts, _ = synthetic
    prob = build_face_problem(ts)
    return prob, fit_per_texel(prob, MODEL, device="cpu")


def same_problem(got: TexelProblem, ref, atol=1e-6):
    for name in ShadingAngles._fields:
        g, r = getattr(got.angles, name), getattr(ref.angles, name)
        assert (g is None) == (r is None), name
        if g is not None:
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(got.intensity, ref.intensity, rtol=0, atol=atol)
    assert np.array_equal(got.weights, ref.weights) and np.array_equal(got.face_ids, ref.face_ids)
    for name in ("pixels", "points", "normals"):
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None), name
        if g is not None:
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
    assert (got.geometry is None) == (ref.geometry is None)
    if got.geometry is not None:
        assert isinstance(got.geometry, ShadingGeometry)
        for g, r in zip(got.geometry, ref.geometry):
            np.testing.assert_allclose(g, r, rtol=0, atol=atol)


def test_scene_converts_whole(synthetic):
    js, ts, _ = synthetic
    assert isinstance(ts, Scene) and ts.num_views == 16 and ts.name == "synthetic"
    assert np.array_equal(ts.images, js.images) and ts.images.max() > 0.1
    cov = ts.raster_map(0).coverage
    assert np.array_equal(cov, js.raster_map(0).coverage) and 0.05 < cov.mean() < 0.5


@pytest.mark.parametrize("kw", [dict(), dict(with_geometry=True, tangent_frame=True),
                                dict(dtype=np.float64)],
                         ids=["default", "geometry+tangent", "float64"])
def test_build_face_problem_equals_jax(synthetic, kw):
    js, ts, _ = synthetic
    got, ref = build_face_problem(ts, **kw), j_fit.build_face_problem(js, **kw)
    if "dtype" in kw:
        assert got.angles.cos_ln.dtype == np.float64
        np.testing.assert_allclose(got.angles.cos_nh, ref.angles.cos_nh, rtol=0, atol=1e-12)
        return
    same_problem(got, ref)
    assert got.intensity.shape == (len(got.face_ids), 16, 3) and len(got.face_ids) > 100
    assert got.weights.min() == 0.0 or got.weights.all()


@pytest.mark.parametrize("kw", [dict(stride=2), dict(stride=3, smooth_normals=False,
                                                     with_geometry=True)],
                         ids=["stride2", "stride3-flat-geometry"])
def test_build_pixel_problem_equals_jax(synthetic, kw):
    js, ts, _ = synthetic
    got, ref = build_pixel_problem(ts, **kw), j_fit.build_pixel_problem(js, **kw)
    same_problem(got, ref)
    assert got.pixels.shape == (len(got.face_ids), 2) and len(got.face_ids) > 200


@pytest.mark.parametrize("build", [build_face_problem, build_pixel_problem])
def test_shadow_weights_name_what_is_missing(synthetic, build):
    """``shadow_weights=True`` is ported now (ROADMAP.md Queue A item 10):
    the problem equals the JAX package's, its weights only lose what the
    shadow maps of the rig's LEDs take away."""
    js, ts, _ = synthetic
    j_build = getattr(j_fit, build.__name__)
    kw = dict(shadow_weights=True, shadow_resolution=256)
    got, ref = build(ts, **kw), j_build(js, **kw)
    same_problem(got, ref)
    plain = build(ts)
    assert (got.weights <= plain.weights).all() and got.weights.sum() <= plain.weights.sum()


def test_fit_recovers_the_parameters(synthetic, face_fit):
    _, _, true_params = synthetic
    prob, rep = face_fit
    assert rep.converged_fraction() > 0.97
    true_sub = true_params[prob.face_ids]
    seen = prob.weights.sum(-1) >= 8
    kd_err = np.abs(rep.params.numpy()[seen, :, 0] - true_sub[seen, :, 0])
    assert np.median(kd_err) < 0.02
    assert np.median(rep.result.chi2.numpy()[seen]) < 1e-4


def test_render_from_the_fit_reproduces_the_images(synthetic, face_fit):
    _, ts, _ = synthetic
    _, rep = face_fit
    cov = ts.raster_map(0).coverage
    for view in (0, 9):
        img = render_image(MODEL, ts, rep.params.numpy(), rep.face_ids, view=view,
                           use_vertex_normals=False, device="cpu")
        rms = float(np.sqrt(np.mean((img[cov] - ts.images[view][cov]) ** 2)))
        assert rms < 0.02, (view, rms)


def test_the_port_renders_the_scene_the_jax_package_rendered(synthetic):
    js, ts, true_params = synthetic
    faces = np.arange(js.mesh.num_faces)
    for view in (0, 5, 15):
        img = render_image(MODEL, ts, true_params, faces, view=view, use_vertex_normals=False,
                           device="cpu")
        np.testing.assert_allclose(img, js.images[view], rtol=3e-5, atol=1e-6)


def test_pixel_fit_closes_the_loop(synthetic):
    """Pixel-granularity texels with face normals, to match the flat-shaded
    images (``tests/test_texel.py::test_pixel_problem_fit_quality``)."""
    _, ts, true_params = synthetic
    prob = build_pixel_problem(ts, stride=2, smooth_normals=False)
    rep = fit_per_texel(prob, MODEL, device="cpu")
    assert rep.converged_fraction() > 0.97
    img = render_pixel_fit(MODEL, ts, rep.params.numpy(), prob.pixels, prob.points, prob.normals,
                           device="cpu")
    ys, xs = prob.pixels[:, 1], prob.pixels[:, 0]
    rms = float(np.sqrt(np.mean((img[ys, xs] - ts.images[0][ys, xs]) ** 2)))
    assert rms < 0.02, rms
    seen = prob.weights.sum(-1) >= 8
    kd_err = np.abs(rep.params.numpy()[:, :, 0] - true_params[prob.face_ids][:, :, 0])
    assert np.median(kd_err[seen]) < 0.02


def test_relight_from_the_fit_changes_the_image(synthetic, face_fit):
    _, ts, _ = synthetic
    _, rep = face_fit
    a = relight(MODEL, ts, rep.params.numpy(), rep.face_ids,
                lights=np.asarray([[300.0, 150.0, 300.0]]), device="cpu")
    b = relight(MODEL, ts, rep.params.numpy(), rep.face_ids,
                lights=np.asarray([[-300.0, 150.0, 300.0]]), device="cpu")
    cov = ts.raster_map(0).coverage
    assert np.abs(a[cov] - b[cov]).mean() > 1e-3


def test_fit_quality_metrics_match_jax(synthetic, face_fit):
    js, _, _ = synthetic
    prob, rep = face_fit
    params = rep.params.numpy()
    chi2, stop = rep.result.chi2.numpy(), rep.result.stop.numpy()
    gains = np.linspace(0.9, 1.1, 16).astype(np.float32)
    j_prob = j_fit.build_face_problem(js)
    for kw in (dict(chi2=chi2, stop=stop), dict(mask_saturation=False), dict(view_gains=gains)):
        got = fit_quality_metrics(prob, params, MODEL, device="cpu", **kw)
        ref = j_fit.fit_quality_metrics(j_prob, params, MODEL, **kw)
        assert got.keys() == ref.keys()
        for key, r in ref.items():
            if key in ("model", "texels", "fraction_at_bounds", "warnings", "converged_fraction",
                       "view_gains"):
                assert got[key] == r, key
            elif key == "chi2":
                assert got[key] == pytest.approx(r, rel=1e-6)
            else:
                np.testing.assert_allclose(got[key], r, rtol=1e-4, atol=1e-7, err_msg=key)
    good = fit_quality_metrics(prob, rep.params, MODEL, chi2=rep.result.chi2, stop=rep.result.stop,
                               device="cpu")                       # tensors are taken as well
    assert max(good["reprojection_mae"]) < 5e-3 and good["warnings"] == []
    assert good["converged_fraction"] > 0.97
    assert all(v["upper"] < 0.05 for v in good["fraction_at_bounds"].values())


def test_fit_quality_metrics_flag_a_degenerate_map(synthetic, face_fit):
    js, _, _ = synthetic
    prob, rep = face_fit
    bad = rep.params.numpy().copy()
    bad[:, :, 0] = 0.0
    bad[:, :, 1] = 100.0
    got = fit_quality_metrics(prob, bad, MODEL, device="cpu")
    ref = j_fit.fit_quality_metrics(j_fit.build_face_problem(js), bad, MODEL)
    assert got["warnings"] == ref["warnings"]
    kinds = " ".join(got["warnings"])
    assert "kd" in kinds and "LOWER" in kinds and "ks" in kinds and "UPPER" in kinds
    assert max(got["reprojection_mae"]) > 0.05
    # the audit of a joint normal-map fit drops the hint to refit with that tier
    joint = fit_quality_metrics(prob, bad, MODEL, joint_normals=True, device="cpu")
    ref = j_fit.fit_quality_metrics(j_fit.build_face_problem(js), bad, MODEL, joint_normals=True)
    assert joint["warnings"] == ref["warnings"] != got["warnings"]


def test_a_problem_converted_to_tensors_fits_the_same(synthetic, face_fit):
    """``build_face_problem`` hands back numpy leaves; ``convert.from_numpy``
    turns them into tensors, and the fit takes either."""
    prob, rep = face_fit
    as_tensors = convert.from_numpy(prob)
    assert isinstance(as_tensors.intensity, torch.Tensor) and isinstance(as_tensors.face_ids, np.ndarray)
    again = fit_per_texel(as_tensors, MODEL, device="cpu")
    assert torch.equal(again.params, rep.params)
