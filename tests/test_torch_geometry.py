"""The port's host path (io, mesh, camera, rasterizer, texelization, scene)
against the JAX package's modules of the same names on the same seeded numpy
inputs. These are NumPy on both sides, so most comparisons are exact."""

import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.geometry import Camera as JCamera, TriangleMesh as JMesh  # noqa: E402
from brdf_tpu.geometry import camera as j_camera, rasterize as j_rasterize  # noqa: E402
from brdf_tpu.geometry import texel as j_texel  # noqa: E402
from brdf_tpu.io import cal as j_cal, images as j_images, obj as j_obj  # noqa: E402
from brdf_tpu.pipeline import scene as j_scene  # noqa: E402
from brdf_tpu_torch import convert, native  # noqa: E402
from brdf_tpu_torch.geometry import Camera, TriangleMesh  # noqa: E402
from brdf_tpu_torch.geometry import camera as t_camera, rasterize as t_rasterize  # noqa: E402
from brdf_tpu_torch.geometry import texel as t_texel  # noqa: E402
from brdf_tpu_torch.geometry.primitives import icosphere  # noqa: E402
from brdf_tpu_torch.io import cal as t_cal, images as t_images, obj as t_obj  # noqa: E402
from brdf_tpu_torch.io import led_rig_positions  # noqa: E402
from brdf_tpu_torch.pipeline import scene as t_scene  # noqa: E402

CAL_TEXT = """<camera_model>CameraTsai</camera_model>
<cx>402.5</cx> <cy>297.25</cy> <f>1510.0</f> <sx>1.002</sx> <kappa1>1.66e-8</kappa1>
<nx>0.98</nx><ny>0.0</ny><nz>-0.19899749</nz>
<ox>0.0</ox><oy>1.0</oy><oz>0.0</oz>
<ax>0.19899749</ax><ay>0.0</ay><az>0.98</az>
<px>-40.0</px><py>150.0</py><pz>-300.0</pz>
"""
OBJ_TEXT = """# a quad, a triangle with texture slots, one with relative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
f 1 2 3 4
f 1/1 2/2 5/3
f -1 -3 -2
"""


def both_cameras(tmp_path, dtype64=True):
    path = tmp_path / "rig.cal"
    path.write_text(CAL_TEXT)
    jc = JCamera.from_calibration(j_cal.load_cal(str(path)), 800, 600,
                                  dtype=jnp.float64 if dtype64 else jnp.float32)
    tc = Camera.from_calibration(t_cal.load_cal(str(path)), 800, 600,
                                 dtype=np.float64 if dtype64 else np.float32)
    return jc, tc


def same_fields(a, b):
    assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def sphere_scene(subdiv=2, size=(160, 120)):
    """``tests/test_pipeline.py``'s sphere, camera and rig in both packages,
    with random images (a geometry test needs no rendering)."""
    v, f = icosphere(subdiv, radius=30.0, center=(0.0, 150.0, 120.0))
    kw = dict(eye=(0.0, 150.0, 320.0), target=(0.0, 150.0, 120.0), up=(0, 1, 0), f=300.0,
              width=size[0], height=size[1])
    lights = led_rig_positions()
    images = np.random.default_rng(0).uniform(0, 1, (16, size[1], size[0], 3)).astype(np.float32)
    js = j_scene.Scene(mesh=JMesh.from_arrays(v, f), cameras=[JCamera.look_at(**kw)] * 16,
                       lights=lights, images=images)
    ts = t_scene.Scene(mesh=TriangleMesh.from_arrays(v, f), cameras=[Camera.look_at(**kw)] * 16,
                       lights=lights, images=images)
    return js, ts


@pytest.fixture(autouse=True)
def own_cache_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("BRDF_TPU_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, str(tmp_path / "torch_cache"))


def test_cal_and_obj_readers(tmp_path):
    (tmp_path / "m.obj").write_text(OBJ_TEXT)
    (tmp_path / "c.cal").write_text(CAL_TEXT)
    jv, jf = j_obj.load_obj(str(tmp_path / "m.obj"))
    tv, tf = t_obj.load_obj(str(tmp_path / "m.obj"))
    assert tf.shape == (4, 3) and tf.dtype == np.int32
    assert np.array_equal(tv, jv) and np.array_equal(tf, jf)
    jc, tc = j_cal.load_cal(str(tmp_path / "c.cal")), t_cal.load_cal(str(tmp_path / "c.cal"))
    assert tc.kappa1 == jc.kappa1 == 1.66e-8 and tc.camera_model == "CameraTsai"
    assert np.array_equal(tc.rotation, jc.rotation) and np.array_equal(tc.p, jc.p)
    assert t_cal.parse_cal_text("<f>12.5<cx>3") == j_cal.parse_cal_text("<f>12.5<cx>3")
    (tmp_path / "bad.cal").write_text("<cx>1</cx>")
    with pytest.raises(KeyError, match="cy"):
        t_cal.load_cal(str(tmp_path / "bad.cal"))
    (tmp_path / "empty.obj").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no vertices"):
        t_obj.load_obj(str(tmp_path / "empty.obj"))


def test_image_readers(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for stem in ("1", "2", "3", "dark"):
        hi = 40 if stem == "dark" else 256
        Image.fromarray(rng.integers(0, hi, (6, 8, 3), dtype=np.uint8)).save(tmp_path / f"{stem}.png")
    got = t_images.load_scene_images(str(tmp_path), 3)
    assert got.shape == (3, 6, 8, 3) and got.dtype == np.float32 and got.min() >= 0.0
    assert np.array_equal(got, j_images.load_scene_images(str(tmp_path), 3))
    raw = t_images.load_image_stack(str(tmp_path), 3)
    assert np.array_equal(raw, j_images.load_image_stack(str(tmp_path), 3))
    assert np.array_equal(got, np.clip(raw - t_images.load_dark_frame(str(tmp_path))[None], 0, 1))
    with pytest.raises(FileNotFoundError, match="image 4"):
        t_images.load_image_stack(str(tmp_path), 4)


def test_mesh_normals_and_transforms():
    v, f = icosphere(2, radius=3.0, center=(1.0, -2.0, 0.5))
    jm, tm = JMesh.from_arrays(v, f), TriangleMesh.from_arrays(v, f)
    same_fields(jm, tm)
    assert tm.vertices.dtype == np.float32 and tm.num_faces == 320 and tm.num_vertices == 162
    np.testing.assert_allclose(np.linalg.norm(tm.face_normals, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tm.vertex_normals, axis=-1), 1.0, atol=1e-6)
    same_fields(jm.scaled(2.5), tm.scaled(2.5))
    same_fields(jm.centered(), tm.centered())
    t64 = TriangleMesh.from_arrays(v, f, dtype=np.float64)
    assert t64.centroids.dtype == np.float64
    same_fields(convert.from_numpy(jm), tm)


def test_mesh_from_obj(tmp_path):
    (tmp_path / "m.obj").write_text(OBJ_TEXT)
    same_fields(JMesh.from_obj(str(tmp_path / "m.obj")), TriangleMesh.from_obj(str(tmp_path / "m.obj")))


@pytest.mark.parametrize("dtype64", [True, False], ids=["float64", "float32"])
def test_camera_fields_equal(tmp_path, dtype64):
    jc, tc = both_cameras(tmp_path, dtype64)
    same_fields(jc, tc)
    kw = dict(eye=(5.0, -10.0, 320.0), target=(0.0, 0.0, 120.0), f=300.0, width=200, height=160)
    same_fields(JCamera.look_at(**kw), Camera.look_at(**kw))
    assert Camera.look_at(**kw).rotation.dtype == np.float32
    same_fields(convert.from_numpy(jc), tc)


def test_project_tensor_numpy_and_jax_agree(tmp_path):
    jc, tc = both_cameras(tmp_path)
    pts = np.random.default_rng(0).normal(size=(500, 3)) * 60 + np.array([80.0, 50.0, 260.0])
    uv_t, z_t = tc.project(torch.tensor(pts))
    uv_n, z_n = t_camera.project_np(tc, pts)
    uv_j, z_j = jc.project(jnp.asarray(pts))
    assert uv_t.dtype == torch.float64 and uv_t.shape == (500, 2)
    np.testing.assert_allclose(uv_t.numpy(), uv_n, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(z_t.numpy(), z_n, rtol=1e-12)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-12)
    juv, jz = j_camera.project_np(jc, pts)
    assert np.array_equal(uv_n, juv) and np.array_equal(z_n, jz)
    np.testing.assert_allclose(tc.world_to_camera(torch.tensor(pts)).numpy(),
                               np.asarray(jc.world_to_camera(jnp.asarray(pts))), rtol=1e-12)


def test_pixel_rays_round_trip_and_distortion(tmp_path):
    jc, tc = both_cameras(tmp_path)
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(50, 750, 64), rng.uniform(50, 550, 64)], -1)
    rays = tc.pixel_rays(torch.tensor(uv))
    np.testing.assert_allclose(rays.numpy(), np.asarray(jc.pixel_rays(jnp.asarray(uv))), rtol=1e-10)
    uv_back, z = tc.project(torch.tensor(tc.position)[None, :] + 300.0 * rays)
    assert bool((z > 0).all())
    np.testing.assert_allclose(uv_back.numpy(), uv, atol=1e-3)
    # kappa1 bends corner rays more than central ones
    tc0 = tc._replace(kappa1=np.zeros_like(tc.kappa1))
    bend = lambda px: float(torch.linalg.vector_norm(      # noqa: E731
        tc.pixel_rays(torch.tensor([px])) - tc0.pixel_rays(torch.tensor([px]))))
    assert bend([10.0, 10.0]) > bend([400.0, 300.0])


def test_project_is_differentiable_and_float32(tmp_path):
    _, tc = both_cameras(tmp_path, dtype64=False)
    pts = torch.tensor([[10.0, 140.0, 100.0], [-20.0, 160.0, 90.0]], requires_grad=True)
    uv, z = tc.project(pts)
    assert uv.dtype == torch.float32
    (g,) = torch.autograd.grad(uv.sum() + z.sum(), [pts])
    assert torch.isfinite(g).all() and bool((g != 0).any())


def test_frustum_params(tmp_path):
    jc, tc = both_cameras(tmp_path)
    got = [float(x) for x in tc.frustum_params(1.0, 1000.0)]
    assert got == [float(x) for x in jc.frustum_params(1.0, 1000.0)]
    l, r, b, t, _, _ = got
    assert l < 0 < r and b < 0 < t
    np.testing.assert_allclose(r - l, tc.width / (tc.f * tc.sx), rtol=1e-6)


def test_native_rasterizer_builds_in_its_own_directory():
    fn = native.rasterizer_lib()
    if shutil.which("g++") is None:
        assert fn is None          # no toolchain: callers keep the NumPy version
        return
    assert fn is not None
    lib = native.BUILD_DIR / "librasterizer.so"
    assert lib.exists() and native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert (native.CSRC / "rasterizer.cpp").exists() and "brdf_tpu_torch" in str(native.CSRC)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_rasterize_equals_jax_package(use_native):
    """The same map bit for bit: face ids, barycentrics and depth."""
    v, f = icosphere(3, radius=30.0, center=(0.0, 0.0, 120.0))
    kw = dict(eye=(5.0, -10.0, 320.0), target=(0.0, 0.0, 120.0), f=300.0, width=200, height=160)
    got = t_rasterize.rasterize_mesh(Camera.look_at(**kw), v, f, native=use_native)
    ref = j_rasterize.rasterize_mesh(JCamera.look_at(**kw), v, f, native=use_native)
    same_fields(ref, got)
    assert 0.05 < got.coverage.mean() < 0.5
    assert got.face_id.dtype == np.int32 and got.bary.dtype == np.float32
    assert np.isinf(got.depth[~got.coverage]).all()


def test_rasterize_native_matches_numpy():
    """``tests/test_rasterize_native.py``'s scene and bars."""
    v, f = icosphere(3, radius=30.0, center=(0.0, 0.0, 120.0))
    cam = Camera.look_at(eye=(5.0, -10.0, 320.0), target=(0.0, 0.0, 120.0), f=300.0,
                         width=200, height=160)
    a = t_rasterize.rasterize_mesh(cam, v, f, native=True)
    b = t_rasterize.rasterize_mesh(cam, v, f, native=False)
    np.testing.assert_array_equal(a.face_id, b.face_id)
    cov = b.coverage
    np.testing.assert_allclose(a.depth[cov], b.depth[cov], rtol=1e-6)
    np.testing.assert_allclose(a.bary[cov], b.bary[cov], rtol=1e-4, atol=1e-6)


def test_rasterize_culls_behind_and_off_screen():
    v, f = icosphere(1, radius=1.0, center=(0.0, 0.0, 5.0))
    cam = Camera.look_at(eye=(0, 0, 0), target=(0, 0, -1), f=50.0, width=32, height=32)
    for use_native in (True, False):
        rm = t_rasterize.rasterize_mesh(cam, v, f, native=use_native)       # behind the camera
        assert not rm.coverage.any()
    cam = Camera.look_at(eye=(0, 0, 0), target=(1, 0, 0), f=50.0, width=32, height=32)
    assert not t_rasterize.rasterize_mesh(cam, v, f).coverage.any()          # off to the side


def test_centroid_projection_map():
    js, ts = sphere_scene()
    got = t_rasterize.centroid_projection_map(ts.cameras[0], ts.mesh.vertices, ts.mesh.faces)
    ref = j_rasterize.centroid_projection_map(js.cameras[0], js.mesh.vertices, js.mesh.faces)
    assert got.dtype == np.int32 and (got >= 0).sum() > 50
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("stride,smooth", [(1, True), (2, True), (2, False)])
def test_pixel_texels(stride, smooth):
    js, ts = sphere_scene()
    got = t_texel.pixel_texels(ts.mesh, ts.raster_map(0), stride=stride, smooth_normals=smooth)
    ref = j_texel.pixel_texels(js.mesh, js.raster_map(0), stride=stride, smooth_normals=smooth)
    same_fields(ref, got)
    d = np.linalg.norm(got.points - np.array([0.0, 150.0, 120.0]), axis=-1)
    np.testing.assert_allclose(d, 30.0, atol=1.5)
    np.testing.assert_allclose(np.linalg.norm(got.normals, axis=-1), 1.0, atol=1e-5)
    same_fields(convert.from_numpy(ref), got)


def test_sample_views_and_bilinear():
    js, ts = sphere_scene()
    tex = t_texel.pixel_texels(ts.mesh, ts.raster_map(0), stride=2)
    i_t, w_t = t_texel.sample_views(tex, ts)
    i_j, w_j = j_texel.sample_views(j_texel.Texelization(*tex), js)
    assert i_t.shape == (len(tex.points), 16, 3) and w_t.mean() > 0.95
    assert np.array_equal(i_t, i_j) and np.array_equal(w_t, w_j)
    img = np.arange(24, dtype=np.float64).reshape(4, 6, 1)
    u, v = np.array([0.5, 2.0, 9.0]), np.array([0.5, 1.0, -3.0])
    got = t_texel._bilinear(img, u, v)
    assert np.array_equal(got, j_texel._bilinear(img, u, v))
    np.testing.assert_allclose(got[:, 0], [0.0, 0.25 * (1 + 2 + 7 + 8), 5.0])


def test_raster_map_caches_in_memory_and_on_its_own_disk_directory(tmp_path):
    _, ts = sphere_scene(subdiv=1, size=(64, 48))
    rm = ts.raster_map(0)
    assert ts.raster_map(5) is rm                        # one camera object, one map
    files = os.listdir(tmp_path / "torch_cache")
    assert len(files) == 1 and files[0].startswith("raster_") and files[0].endswith(".npz")
    assert not (tmp_path / "jax_cache").exists()
    assert "brdf_tpu_torch_cache" in t_scene._default_cache_dir()
    ts._raster_cache.clear()
    same_fields(ts.raster_map(0), rm)                    # read back from the disk tier
    (tmp_path / "torch_cache" / files[0]).write_bytes(b"not a zip file")
    ts._raster_cache.clear()
    same_fields(ts.raster_map(0), rm)                    # a corrupt entry is rebuilt
    np.testing.assert_array_equal(ts.eyes(), np.tile(ts.cameras[0].position, (16, 1)))


def test_raster_map_without_the_disk_tier(tmp_path, monkeypatch):
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, "")
    js, ts = sphere_scene(subdiv=1, size=(64, 48))
    same_fields(js.raster_map(0), ts.raster_map(0))
    assert not (tmp_path / "torch_cache").exists()


def test_load_reference_scene_layout(tmp_path):
    from PIL import Image

    folder = tmp_path / "thing"
    folder.mkdir()
    (folder / "thing.obj").write_text(OBJ_TEXT)
    (folder / "thing.cal").write_text(CAL_TEXT)
    rng = np.random.default_rng(3)
    for stem in ("1", "2", "dark"):
        Image.fromarray(rng.integers(0, 200, (6, 8, 3), dtype=np.uint8)).save(folder / f"{stem}.png")
    got = t_scene.load_reference_scene(str(folder), num_images=2)
    ref = j_scene.load_reference_scene(str(folder), num_images=2)
    assert got.name == "thing" and got.num_views == 2 and got.cameras[0] is got.cameras[1]
    assert (got.cameras[0].width, got.cameras[0].height) == (8, 6)
    same_fields(ref.mesh, got.mesh)
    same_fields(ref.cameras[0], got.cameras[0])
    assert np.array_equal(got.images, ref.images) and np.array_equal(got.lights, ref.lights)
    os.remove(folder / "thing.cal")
    with pytest.raises(FileNotFoundError, match="no .cal"):
        t_scene.load_reference_scene(str(folder), num_images=2)


def test_convert_scene_keeps_repeated_cameras_one_object():
    js, ts = sphere_scene(subdiv=1, size=(64, 48))
    got = convert.from_numpy(js)
    assert isinstance(got, t_scene.Scene) and isinstance(got.mesh, TriangleMesh)
    assert all(c is got.cameras[0] for c in got.cameras) and isinstance(got.cameras[0], Camera)
    same_fields(got.mesh, ts.mesh)
    same_fields(got.cameras[0], ts.cameras[0])
    assert np.array_equal(got.images, ts.images) and got.name == js.name
    same_fields(convert.from_numpy(js.raster_map(0)), ts.raster_map(0))
    back = convert.to_numpy(ts)
    assert isinstance(back, t_scene.Scene) and back.cameras[3] is back.cameras[0]
    same_fields(convert.to_numpy(ts.raster_map(0)), ts.raster_map(0))
