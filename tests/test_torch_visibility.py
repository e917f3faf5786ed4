"""Cast-shadow visibility (brdf_tpu_torch/geometry/visibility.py) against the
JAX package's on the cases of tests/test_visibility.py: the same shadow
maps from the same rasterizer, so the (T, V) visibility is equal, entry for
entry. The real-mesh case runs on the bumped sphere of
tools/synthetic_scene.py under the 16-LED rig."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from brdf_tpu.geometry import visibility as jv  # noqa: E402
from brdf_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from brdf_tpu.geometry.mesh import TriangleMesh as JMesh  # noqa: E402
from brdf_tpu.geometry.primitives import icosphere, plane  # noqa: E402
from brdf_tpu.pipeline import fit as j_fit  # noqa: E402
from brdf_tpu.pipeline.scene import Scene as JScene  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.geometry import TriangleMesh, visibility as tv  # noqa: E402
from brdf_tpu_torch.io import led_rig_positions  # noqa: E402
from brdf_tpu_torch.pipeline.fit import build_face_problem, build_pixel_problem  # noqa: E402
from brdf_tpu_torch.pipeline import scene as t_scene  # noqa: E402
from tools.synthetic_scene import bumped_sphere  # noqa: E402


@pytest.fixture(autouse=True)
def _raster_caches(tmp_path, monkeypatch):
    """Both packages' raster-map disk caches in this test's own directory."""
    monkeypatch.setenv("BRDF_TPU_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, str(tmp_path / "torch"))


def _plane_with_occluder():
    """tests/test_visibility.py's z=0 ground plane under a small square
    occluder at z=1, as arrays."""
    pv, pf = plane(size=4.0, resolution=8)
    ov, of_ = plane(size=0.8, center=(0.0, 0.0, 1.0), resolution=1)
    return np.concatenate([ov, pv]), np.concatenate([of_, pf + len(ov)])


def _both(verts, faces, points, lights, **kw):
    vj = jv.light_visibility(JMesh.from_arrays(verts, faces), points, lights, **kw)
    vt = tv.light_visibility(TriangleMesh.from_arrays(verts, faces), points, lights, **kw)
    assert vt.dtype == np.float32 and vt.shape == (len(points), len(lights))
    np.testing.assert_array_equal(vt, vj)
    return vt


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_occluder_casts_and_moves_its_shadow(native):
    verts, faces = _plane_with_occluder()
    pts = np.array([[0.0, 0.0, 0.0], [1.5, 1.5, 0.0], [-1.5, 1.5, 0.0], [1.5, -1.5, 0.0],
                    [-1.5, -1.5, 0.0]])
    vis = _both(verts, faces, pts, np.array([[0.0, 0.0, 10.0]]), resolution=256, native=native)
    assert vis[0, 0] == 0.0 and np.all(vis[1:, 0] == 1.0)
    pts = np.array([[0.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.5, 0.0, 0.0]])
    vis = _both(verts, faces, pts, np.array([[10.0, 0.0, 10.0]]), resolution=512, native=native)
    assert vis[1, 0] == 0.0 and vis[2, 0] == 1.0


def test_no_self_shadow_acne_and_light_inside():
    verts, faces = icosphere(subdivisions=3, radius=1.0)
    mesh = TriangleMesh.from_arrays(verts, faces)
    light = np.array([[0.0, 0.0, 5.0]])
    front = mesh.centroids[mesh.centroids[:, 2] > 0.25]
    back = mesh.centroids[mesh.centroids[:, 2] < -0.25]
    assert _both(verts, faces, front, light, resolution=512).mean() > 0.995
    assert _both(verts, faces, back, light, resolution=512).mean() < 0.05
    small_v, small_f = icosphere(subdivisions=2, radius=1.0)
    inside = _both(small_v, small_f, TriangleMesh.from_arrays(small_v, small_f).centroids,
                   np.zeros((1, 3)))
    assert np.all(inside == 1.0)
    assert tv.light_camera(np.zeros(3), np.zeros(3), 1.0) is None
    cam_t = tv.light_camera(np.array([0.0, 0.0, 10.0]), np.zeros(3), 1.0, resolution=128)
    cam_j = jv.light_camera(np.array([0.0, 0.0, 10.0]), np.zeros(3), 1.0, resolution=128)
    for name in ("rotation", "position", "f", "cx", "cy"):
        np.testing.assert_array_equal(np.asarray(getattr(cam_t, name)),
                                      np.asarray(getattr(cam_j, name)), err_msg=name)


def test_synthetic_scan_under_the_rig():
    """tests/test_visibility.py's real-mesh case on the bumped sphere of the
    synthetic scan: well-formed, equal to the JAX package's, mostly lit, and
    the bumps shadow some faces from the grazing LEDs."""
    verts, faces = bumped_sphere(3)
    mesh = TriangleMesh.from_arrays(verts, faces)
    lights = led_rig_positions()[:4]
    vis = _both(verts, faces, mesh.centroids, lights, resolution=512)
    assert set(np.unique(vis)) <= {0.0, 1.0}
    assert vis.mean() > 0.3
    assert 0.0 < vis.mean() < 1.0


@pytest.mark.parametrize("build", [build_face_problem, build_pixel_problem])
def test_shadow_weights_zero_out_problem_views(build):
    """tests/test_visibility.py::test_shadow_weights_zero_out_problem_views
    through both builders of both packages: the same problem, and the faces
    under the occluder lose the overhead light (view 0)."""
    verts, faces = _plane_with_occluder()
    cam = JCamera.look_at(eye=(0.0, -3.0, 3.5), target=(0.0, 0.0, 0.0), up=(0, 0, 1),
                          f=220.0, width=160, height=120)
    lights = np.array([[0.0, 0.0, 10.0], [8.0, 0.0, 8.0]], np.float64)
    images = np.full((2, 120, 160, 3), 0.5, np.float32)
    js = JScene(mesh=JMesh.from_arrays(verts, faces), cameras=[cam, cam], lights=lights,
                images=images, name="occluder")
    ts = convert.from_numpy(js)
    j_build = getattr(j_fit, build.__name__)
    base, shad = build(ts), build(ts, shadow_weights=True)
    ref = j_build(js, shadow_weights=True)
    np.testing.assert_array_equal(shad.weights, np.asarray(ref.weights))
    np.testing.assert_array_equal(shad.face_ids, np.asarray(ref.face_ids))
    w0, w1 = np.asarray(base.weights), np.asarray(shad.weights)
    assert np.all(w1 <= w0 + 1e-7)
    assert ((w0 > 0) & (w1 == 0)).any()
    # texel positions: the face centroids, or the pixel texels' surface points
    pts = ts.mesh.centroids[shad.face_ids] if shad.points is None else shad.points
    rows = np.nonzero((np.abs(pts[:, 0]) < 0.25) & (np.abs(pts[:, 1]) < 0.25)
                      & (np.abs(pts[:, 2]) < 1e-6))[0]
    assert len(rows) and np.all(w1[rows, 0] == 0.0)
