"""Environment-map relighting (brdf_tpu_torch/pipeline/envlight.py) against
the JAX package's on the cases of tests/test_envlight.py, on the same NumPy
inputs and synthetic scenes.

The host NumPy half (lat-long directions and solid angles, ``env_to_lights``,
``lookup_latlong``, the SH9 projection) is a copy and equals the JAX
package's bit for bit. ``shade_env_samples`` evaluates the lobe through the
shading kernel K2 (its plain version here), and
``relight_env`` gathers the covered pixels on the host as ``relight`` does;
both agree with the JAX package to rtol 3e-5, atol 1e-6 (chip_smoke.py's
XLA_RTOL / XLA_ATOL: float32 lobes summed in another order)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.geometry import Camera as JCamera, TriangleMesh as JMesh  # noqa: E402
from brdf_tpu.io import led_rig_positions  # noqa: E402
from brdf_tpu.pipeline import envlight as je  # noqa: E402
from brdf_tpu.pipeline.scene import Scene as JScene  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.ops import shading as k0  # noqa: E402
from brdf_tpu_torch.pipeline import envlight as te, scene as t_scene  # noqa: E402
from tools.synthetic_scene import bumped_sphere  # noqa: E402

RTOL, ATOL = 3e-5, 1e-6


@pytest.fixture(autouse=True)
def _raster_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("BRDF_TPU_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv(t_scene.CACHE_DIR_ENV, str(tmp_path / "torch"))


def _smooth_env(h=64, w=128, c=3, seed=0):
    """tests/test_envlight.py's band-limited, strictly positive environment."""
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(size=(9, c)) * 0.15
    coeffs[0] = 1.0
    dirs = je.latlong_directions(h, w)
    env = je._sh9_basis(dirs) @ coeffs
    lo = env.min()
    if lo <= 0.05:
        coeffs[0] += (0.1 - lo) / 0.282095
        env = je._sh9_basis(dirs) @ coeffs
    return env, coeffs


def test_host_half_equals_jax():
    """Directions, solid angles (summing to 4π), both sampling methods, the
    bilinear lookup and the SH9 projection: the same arrays."""
    np.testing.assert_array_equal(te.latlong_directions(32, 64), je.latlong_directions(32, 64))
    dw = te.latlong_solid_angles(64, 128)
    np.testing.assert_array_equal(dw, je.latlong_solid_angles(64, 128))
    np.testing.assert_allclose(dw.sum(), 4 * np.pi, rtol=1e-6)
    env, coeffs = _smooth_env(seed=1)
    for method, n in (("importance", 300), ("uniform", 257)):
        for got, ref in zip(te.env_to_lights(env, n=n, method=method),
                            je.env_to_lights(env, n=n, method=method)):
            np.testing.assert_array_equal(got, ref)
    d = te.latlong_directions(16, 32).reshape(-1, 3)
    np.testing.assert_array_equal(te.lookup_latlong(env, d), je.lookup_latlong(env, d))
    np.testing.assert_array_equal(te.sh9_project(env), je.sh9_project(env))
    np.testing.assert_array_equal(te._sh9_basis(d), je._sh9_basis(d))
    with pytest.raises(ValueError, match="positive luminance"):
        te.env_to_lights(np.zeros((8, 16, 3)))
    with pytest.raises(ValueError, match="sampling method"):
        te.env_to_lights(env, method="stratified")


def test_sh9_irradiance_matches_jax_and_quadrature():
    """The closed-form irradiance on tensors equals the JAX package's and
    tests/test_envlight.py's brute-force quadrature; a constant environment
    gives πL0 (the Lambert furnace)."""
    env, _ = _smooth_env()
    coeffs = te.sh9_project(env)
    rng = np.random.default_rng(1)
    n = rng.normal(size=(32, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    got = te.sh9_irradiance(torch.tensor(n), coeffs)
    assert got.dtype == torch.float64 and got.shape == (32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(je.sh9_irradiance(jnp.asarray(n), coeffs)),
                               rtol=1e-12)
    h, w, c = env.shape
    dirs = te.latlong_directions(h, w).reshape(-1, 3)
    dw = te.latlong_solid_angles(h, w).reshape(-1)
    brute = np.einsum("np,p,pc->nc", np.maximum(n @ dirs.T, 0.0), dw, env.reshape(-1, c))
    np.testing.assert_allclose(got.numpy(), brute, rtol=5e-3, atol=5e-3)
    furnace = te.sh9_irradiance(torch.tensor([[0.0, 1.0, 0.0], [0.577, -0.577, 0.577]]),
                                te.sh9_project(np.full((64, 128, 3), 0.7)))
    np.testing.assert_allclose(furnace.numpy(), np.pi * 0.7, rtol=1e-3)


def _surface(rng, n=16):
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pts = rng.normal(size=(n, 3)) * 0.1
    return pts.astype(np.float32), nrm.astype(np.float32), np.array([0.0, 0.0, 10.0], np.float32)


def _params(rng, model, n):
    m = te.MODELS[model].n_params
    cols = [rng.uniform(0.2, 0.8, (n, 3)) for _ in range(2)][: min(m, 2)]
    shape = {"blinn_phong": (3.0, 20.0), "phong": (3.0, 20.0), "oren_nayar": (0.1, 1.0),
             "minnaert": (0.5, 2.0)}.get(model, (0.2, 0.6))
    while len(cols) < m:
        cols.append(rng.uniform(*shape, (n, 3)) if len(cols) < 4 else rng.uniform(-1.0, 1.0, (n, 3)))
    return np.stack(cols, -1).astype(np.float32)


ENV_MODELS = ("lambert", "blinn_phong", "cook_torrance", "ward", "oren_nayar",
              "cook_torrance_aniso")


@pytest.mark.parametrize("model", ENV_MODELS)
@pytest.mark.parametrize("method", ["uniform", "importance"])
def test_shade_env_samples_matches_jax(model, method):
    """S environment samples, drawn by either method, in the view slot of
    K2's plain version against the JAX package's one program, to rtol 3e-5 and
    atol 1e-6 — for cook_torrance on 95% of the entries and every one to
    3e-4, since its GGX lobe turns an ulp of the angles into up to 1e-4
    (ROADMAP.md Queue C; 10 of 3840 entries past 3e-5 over 40 seeds,
    measured); the tangent-frame lobe builds its extra channels."""
    rng = np.random.default_rng(ENV_MODELS.index(model))
    env, _ = _smooth_env(seed=5)
    dirs, rad = te.env_to_lights(env, n=96, method=method)
    pts, nrm, eye = _surface(rng)
    params = _params(rng, model, len(pts))
    ref = je.shade_env_samples(model, jnp.asarray(params), jnp.asarray(pts), jnp.asarray(nrm),
                               jnp.asarray(eye), jnp.asarray(dirs), jnp.asarray(rad))
    before = k0.SHADE_LAUNCHES["fwd"]
    got = te.shade_env_samples(model, params, pts, nrm, eye, dirs, rad, device="cpu")
    assert k0.SHADE_LAUNCHES["fwd"] == before          # no kernel launched on the CPU
    assert got.shape == (len(pts), 3) and got.dtype == torch.float32
    if model == "cook_torrance":
        assert np.isclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL).mean() >= 0.95
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-4, atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0


def test_single_pixel_env_is_a_directional_light():
    """A one-hot environment behaves as one directional light of radiance
    L·Δω (tests/test_envlight.py), through K2's plain version."""
    h, w, iy, ix = 32, 64, 10, 37
    env = np.zeros((h, w, 3))
    env[iy, ix] = (4.0, 2.0, 1.0)
    dirs, rad = te.env_to_lights(env, n=16, method="importance")
    d0, dw0 = te.latlong_directions(h, w)[iy, ix], te.latlong_solid_angles(h, w)[iy, ix]
    np.testing.assert_allclose(rad.sum(0), env[iy, ix] * dw0, rtol=1e-6)
    rng = np.random.default_rng(3)
    pts, nrm, eye = _surface(rng, 8)
    params = np.abs(rng.normal(size=(8, 3, 3))).clip(0.1, 0.9).astype(np.float32)
    out = te.shade_env_samples("blinn_phong", params, pts, nrm, eye, dirs, rad, device="cpu")
    ang = te.directional_angles(torch.tensor(nrm), torch.tensor(pts), torch.tensor(eye),
                                torch.tensor(d0[None], dtype=torch.float32))
    lobe = te.MODELS["blinn_phong"].fn(
        torch.tensor(params), te.ShadingAngles(*(None if a is None else a[:, None, :] for a in ang)))
    want = lobe[..., 0] * torch.tensor(env[iy, ix] * dw0, dtype=torch.float32)[None, :]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The bumped sphere of tools/synthetic_scene.py before the test
    camera, in both packages."""
    patch = pytest.MonkeyPatch()
    cache = tmp_path_factory.mktemp("env_raster_cache")
    patch.setenv("BRDF_TPU_CACHE_DIR", str(cache / "jax"))
    patch.setenv(t_scene.CACHE_DIR_ENV, str(cache / "torch"))
    v, f = bumped_sphere(2)
    cam = JCamera.look_at(eye=(0.0, 150.0, 320.0), target=(0.0, 150.0, 120.0), up=(0, 1, 0),
                          f=300.0, width=96, height=72)
    js = JScene(mesh=JMesh.from_arrays(v, f), cameras=[cam] * 16, lights=led_rig_positions(),
                images=np.zeros((16, 72, 96, 3), np.float32), name="bumped")
    yield js, convert.from_numpy(js)
    patch.undo()


@pytest.mark.parametrize("method", ["uniform", "importance"])
@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance"])
def test_relight_env_matches_jax(scene, model, method):
    """``relight_env`` of a fitted scene under a smooth environment: the
    image equals the JAX package's to rtol 3e-5, atol 1e-6 — for
    cook_torrance on all but 0.5% of the pixels, whose angles differ by an
    ulp that the GGX lobe turns into up to 1e-4 (ROADMAP.md Queue C; 0.19–0.21%
    measured, all within 3e-4) — and the background stays."""
    js, ts = scene
    rng = np.random.default_rng(7)
    t = ts.mesh.num_faces
    shape = rng.uniform(3.0, 20.0, (t, 3)) if model == "blinn_phong" else rng.uniform(0.2, 0.6, (t, 3))
    params = np.stack([rng.uniform(0.2, 0.8, (t, 3)), rng.uniform(0.2, 0.6, (t, 3)), shape],
                      -1).astype(np.float32)
    env, _ = _smooth_env(h=16, w=32, seed=2)
    kw = dict(view=0, n_samples=64, method=method, background=-1.0)
    ref = je.relight_env(model, js, params, np.arange(t), env, **kw)
    got = te.relight_env(model, ts, params, np.arange(t), env, device="cpu", **kw)
    assert got.shape == ref.shape == (72, 96, 3) and got.dtype == np.float32
    close = np.isclose(got, ref, rtol=RTOL, atol=ATOL)
    if model == "blinn_phong":
        assert close.all()
    else:
        assert close.mean() >= 0.995
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=ATOL)
    cov = ts.raster_map(0).coverage
    assert (got[~cov] == -1.0).all() and 0.3 < cov.mean() < 0.95


def test_relight_env_furnace(scene):
    """A constant environment on a Lambert fit gives the furnace value kd·L0
    on the interior pixels (tests/test_envlight.py::test_relight_env_scene)."""
    _, ts = scene
    t = ts.mesh.num_faces
    kd = np.full((t, 3, 1), 0.5, np.float32)
    img = te.relight_env("lambert", ts, kd, np.arange(t), np.full((16, 32, 3), 1.0), view=0,
                         n_samples=2048, method="uniform", device="cpu")
    cov = ts.raster_map(0).coverage
    assert abs(np.median(img[cov]) - 0.5) < 0.05
