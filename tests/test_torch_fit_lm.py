"""The LM slice as a whole: the port's ``fit_texels`` / ``fit_per_texel`` with
``engine="pallas"`` (the fused tier: K5's plain version on the CPU) and
``engine="xla"`` (the eager tier) against the JAX package's
``fit_texels_sharded`` / ``fit_per_texel`` on a one-device CPU mesh, on the
same numpy inputs in float32; the chunked, checkpointed resume; and the
tangent-frame angles.

Two float32 LM solves take different accept decisions once χ² nears its
floor (see test_torch_lm_fused.py), so fits are compared by outcome: the
share of converged lanes, the χ² floor, and the parameters of lanes both
sides converged. Within the port a chunked fit equals the unchunked one
bit for bit."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models import brdf as jb  # noqa: E402
from brdf_tpu.parallel.fit import fit_texels_sharded  # noqa: E402
from brdf_tpu.parallel.mesh import make_mesh  # noqa: E402
from brdf_tpu.pipeline.fit import TexelProblem as JProblem  # noqa: E402
from brdf_tpu.pipeline.fit import fit_per_texel as j_fit_per_texel  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions  # noqa: E402
from brdf_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models import brdf as tb  # noqa: E402
from brdf_tpu_torch.models.normalmap import tangent_basis, tangent_basis_np  # noqa: E402
from brdf_tpu_torch.parallel import fit as tfit  # noqa: E402
from brdf_tpu_torch.pipeline import fit as tpipe  # noqa: E402
from brdf_tpu_torch.pipeline.fit import TexelProblem, fit_per_texel  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions, LMResult  # noqa: E402
from brdf_tpu_torch.utils.checkpoint import FitCheckpointer, latest_step, load_fit_state  # noqa: E402
from torch_port_inputs import ALL_LOBES, agreement, angle_columns, true_params  # noqa: E402

T, V, C = 64, 16, 3
OPTS = dict(eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=30)
CONVERGED = (1, 2, 6)


def _mesh():
    return make_mesh(data=1, view=1, devices=jax.devices()[:1])


def _texels(model, seed, outliers=False):
    """(T, V) targets with N(0, 0.01) noise, a 10% weight mask and, with
    ``outliers``, one bright view per texel for the robust rounds to reject."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, T, V, tangent=jb.MODELS[model].tangent)
    true_p = true_params(model, rng, T)
    ja = jb.ShadingAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    y = np.asarray(jb.MODELS[model].fn(jnp.asarray(true_p), ja))
    y = y + rng.normal(0, 0.01, y.shape)
    if outliers:
        y[np.arange(T), rng.integers(0, V, T)] += 0.5
    w = (rng.uniform(size=(T, V)) > 0.1).astype(np.float32)
    return cols, y.astype(np.float32), w, true_p


def _outcome(rt, rj, m):
    """The by-outcome comparison of two fits (``rt`` the port's)."""
    st, sj = rt.stop.numpy().ravel(), np.asarray(rj.stop).ravel()
    conv_t, conv_j = np.isin(st, CONVERGED), np.isin(sj, CONVERGED)
    ct, cj = rt.chi2.numpy().ravel(), np.asarray(rj.chi2).ravel()
    both = conv_t & conv_j
    pt, pj = rt.p.numpy().reshape(-1, m), np.asarray(rj.p).reshape(-1, m)
    return dict(conv_t=conv_t.mean(), conv_j=conv_j.mean(), both=both.mean(),
                chi2_close=np.isclose(ct, cj, rtol=1e-2, atol=1e-7).mean(),
                p_close=agreement(pt[both], pj[both], 1e-2))


@pytest.mark.parametrize("robust", [None, "huber"])
@pytest.mark.parametrize("engine, model", [("pallas", "blinn_phong"), ("pallas", "oren_nayar"),
                                           ("xla", "blinn_phong"), ("xla", "ward_aniso")])
def test_fit_texels_matches_fit_texels_sharded(engine, model, robust):
    """Same engine on both sides, grid init inside the program, without and
    with two huber rounds. Measured at T=64: equal converged shares (bar:
    within 0.1); χ² within 1e-2 relative on 0.94–1.0 of lanes (bar 0.85: the
    robust weights follow the parameters, which moves a weighted χ² in its
    third digit); parameters of lanes both converged within 1e-2 on
    0.92–1.0 (bar 0.85). The 5-parameter lobe is not identified by 16
    views, so there the bar is χ² alone."""
    cols, y, w, _ = _texels(model, seed=11, outliers=robust is not None)
    m = tb.MODELS[model].n_params
    kw = dict(engine=engine, robust=robust, robust_iters=2 if robust else 0)
    rj = fit_texels_sharded(model, jb.ShadingAngles(**cols), jnp.asarray(y), _mesh(),
                            opts=JOptions(**OPTS), weights=jnp.asarray(w), **kw)
    rt = tfit.fit_texels(model, convert.from_numpy(jb.ShadingAngles(**cols)), torch.tensor(y),
                         opts=LMOptions(**OPTS), weights=torch.tensor(w), device="cpu", **kw)
    assert isinstance(rt, LMResult) and rt.p.shape == (T, m) and rt.stop.dtype == torch.int32
    assert rt.iters.dtype == torch.int32 and rt.nfev.dtype == torch.int32
    out = _outcome(rt, rj, m)
    assert abs(out["conv_t"] - out["conv_j"]) <= 0.1, out
    assert out["chi2_close"] >= 0.85, out
    if m <= 3:
        assert out["both"] >= 0.5 and out["p_close"] >= 0.85, out
    if engine == "pallas":
        # one Jacobian pass, one solve and one trial evaluation per iteration
        it = rt.iters.numpy()
        np.testing.assert_array_equal(rt.nfev.numpy(), 2 * it + 1)
        np.testing.assert_array_equal(rt.njev.numpy(), it)
        np.testing.assert_array_equal(rt.nlss.numpy(), it)
        np.testing.assert_array_equal(np.asarray(rj.nfev), 2 * np.asarray(rj.iters) + 1)
        assert float(rt.chi2_init.abs().max()) == 0.0
    else:
        assert (rt.nfev.numpy() == 1 + rt.nlss.numpy()).all()


@pytest.mark.parametrize("engine", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_every_lobe_fits_through_every_lm_engine(model, engine):
    """All ten lobes at V=16, grid init and three iterations: χ² finite and
    no higher than at the start, parameters inside the box."""
    rng = np.random.default_rng(3)
    t = 24
    cols = angle_columns(rng, t, V, tangent=tb.MODELS[model].tangent)
    ang = convert.from_numpy(jb.ShadingAngles(**cols))
    spec = tb.MODELS[model]
    y = spec.fn(torch.tensor(true_params(model, rng, t)), ang) + 0.01 * torch.tensor(
        rng.normal(size=(t, V)).astype(np.float32))
    res = tfit.fit_texels(model, ang, y, opts=LMOptions(**dict(OPTS, itmax=3)), engine=engine,
                          device="cpu")
    start = tfit.linear_grid_init(model, ang, y)
    chi2_start = ((spec.fn(start, ang) - y) ** 2).sum(-1)
    assert res.p.shape == (t, spec.n_params) and torch.isfinite(res.chi2).all()
    assert (res.chi2 <= chi2_start * (1 + 1e-5) + 1e-12).all()
    lo, hi = torch.tensor(spec.lower), torch.tensor(spec.upper)
    assert ((res.p >= lo) & (res.p <= hi)).all()
    assert ((res.stop >= 1) & (res.stop <= 7)).all() and int(res.iters.max()) <= 3


class _Resolved(Exception):
    """Stops a fit once it has resolved its engine."""


@pytest.mark.parametrize("fit, lobe, device, engine, expected", [
    ("texels", "ward_aniso", "cuda", "auto", "pallas"),
    ("texels", "ward_aniso", "cpu", "auto", "xla"),
    ("texels", "blinn_phong", "cuda", "varpro", "varpro"),
    ("texels", "lambert", "cpu", "pallas", "pallas"),
    ("texels", "lambert", "cuda", "mosaic", "unknown engine"),
    ("joint", "cook_torrance", "cuda", "auto", "pallas"),
    ("joint", "blinn_phong", "cpu", "auto", "xla"),
    ("joint", "cook_torrance_aniso", "cuda", "auto", "xla"),
    ("joint", "ward_aniso", "cuda", "pallas", "pallas"),
    ("joint", "ward", "cuda", "varpro", "varpro"),
    ("joint", "cook_torrance", "cpu", "mosaic", "unknown engine"),
])
def test_one_resolver_serves_both_fits(monkeypatch, fit, lobe, device, engine, expected):
    """``fit_texels`` and ``fit_joint_normalmap`` resolve their engine by
    ``parallel/fit.py::_resolve_engine`` alone: "auto" is "pallas" on a CUDA
    device where a kernel tier takes the fit (any lobe of the per-texel fit,
    a one-shape base lobe of the joint fit), else "xla"; a named engine
    passes as it is and an unknown one raises. The fit stops right after."""
    seen, real = [], tfit._resolve_engine

    def spy(*args):
        seen.append(real(*args))
        raise _Resolved

    dev = torch.device(device)
    monkeypatch.setattr(tfit, "resolve_device", lambda d: dev)
    monkeypatch.setattr(tpipe, "resolve_device", lambda d: dev)
    monkeypatch.setattr(tfit, "_resolve_engine", spy)
    monkeypatch.setattr(tpipe, "_resolve_engine", spy)
    if fit == "texels":
        ang = tb.ShadingAngles(*(torch.zeros(2, 4) for _ in tb.ShadingAngles._fields))
        run = lambda: tfit.fit_texels(lobe, ang, torch.zeros(2, 4), engine=engine)  # noqa: E731
    else:
        geom = tb.ShadingGeometry(n=np.zeros((2, 3), np.float32),
                                  l=np.zeros((2, 4, 3), np.float32),
                                  v=np.zeros((2, 4, 3), np.float32))
        prob = TexelProblem(angles=None, intensity=np.zeros((2, 4, 3), np.float32),
                            weights=np.ones((2, 4), np.float32), face_ids=np.arange(2),
                            geometry=geom)
        run = lambda: tpipe.fit_joint_normalmap(prob, lobe, engine=engine)  # noqa: E731
    if expected == "unknown engine":
        with pytest.raises(ValueError, match="unknown engine"):
            run()
        assert seen == []
        return
    with pytest.raises(_Resolved):
        run()
    assert seen == [expected]


def test_auto_resolves_by_device_and_model(monkeypatch):
    cols, y, w, _ = _texels("lambert", seed=1)
    calls = []
    real_eager, real_fused = tfit.levmar_bc, tfit.lm_fit_fused
    monkeypatch.setattr(tfit, "levmar_bc",
                        lambda *a, **kw: calls.append("eager") or real_eager(*a, **kw))
    monkeypatch.setattr(tfit, "lm_fit_fused",
                        lambda *a, **kw: calls.append("fused") or real_fused(*a, **kw))
    ang = convert.from_numpy(jb.ShadingAngles(**cols))
    tfit.fit_texels("lambert", ang, torch.tensor(y), opts=LMOptions(itmax=3), device="cpu")
    assert calls == ["eager"]
    tfit.fit_texels("lambert", ang, torch.tensor(y), opts=LMOptions(itmax=3), device="cpu",
                    engine="pallas")
    assert calls == ["eager", "fused"]


def test_irls_rounds_follow_the_pipeline_program(monkeypatch):
    """Round 0 takes the caller's weights, start and warm state; round i > 0
    the robust weights, round i − 1's parameters and a cold damping state.
    With no start the grid init runs once, before round 0."""
    model = "cook_torrance"
    cols, y, w, _ = _texels(model, seed=2, outliers=True)
    ang = convert.from_numpy(jb.ShadingAngles(**cols))
    calls, inits = [], []
    real_fused, real_init = tfit.lm_fit_fused, tfit.linear_grid_init

    def fused(model, angles, target, p0, weights=None, warm=None, **kw):
        r = real_fused(model, angles, target, p0, weights=weights, warm=warm, **kw)
        calls.append(dict(p0=p0, weights=weights, warm=warm, p=r.p))
        return r

    monkeypatch.setattr(tfit, "lm_fit_fused", fused)
    monkeypatch.setattr(tfit, "linear_grid_init",
                        lambda *a, **kw: inits.append(1) or real_init(*a, **kw))
    mu = torch.full((T,), 0.25)
    warm = (mu, torch.full((T,), 4.0), torch.zeros(T, dtype=torch.int32))
    res = tfit.fit_texels(model, ang, torch.tensor(y), opts=LMOptions(**OPTS),
                          weights=torch.tensor(w), engine="pallas", warm_state=warm,
                          robust="huber", robust_iters=2, device="cpu")
    assert len(calls) == 3 and inits == [1]
    torch.testing.assert_close(calls[0]["weights"], torch.tensor(w), rtol=0, atol=0)
    torch.testing.assert_close(calls[0]["warm"][0], mu, rtol=0, atol=0)
    assert calls[0]["warm"][2].dtype == torch.float32
    for prev, cur in zip(calls, calls[1:]):
        torch.testing.assert_close(cur["p0"], prev["p"], rtol=0, atol=0)
        assert float(cur["warm"][0].abs().max()) == 0.0 and float(cur["warm"][1].min()) == 2.0
        assert float(cur["warm"][2].abs().max()) == 0.0
        assert not torch.equal(cur["weights"], torch.tensor(w))       # the outlier is downweighted
    torch.testing.assert_close(res.p, calls[-1]["p"], rtol=0, atol=0)
    # a start from the caller skips the init
    tfit.fit_texels(model, ang, torch.tensor(y), opts=LMOptions(itmax=2), p0=res.p,
                    engine="pallas", device="cpu")
    assert inits == [1]


def _problem(model, seed, with_geometry=False):
    """A (T, V, C) problem; with ``with_geometry`` its angles come from a
    synthetic patch under a ring of lights, tangent channels left out."""
    rng = np.random.default_rng(seed)
    geom = None
    if with_geometry:
        points = rng.uniform(-0.5, 0.5, (T, 3)) * np.array([1.0, 1.0, 0.05])
        normals = rng.normal(size=(T, 3)) * 0.3 + np.array([0.0, 0.0, 1.0])
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        phi = np.linspace(0, 2 * np.pi, V, endpoint=False)
        lights = np.stack([2.0 * np.cos(phi), 2.0 * np.sin(phi), 1.5 + 0.5 * np.cos(3 * phi)], -1)
        geom = jb.shading_geometry_np(points, normals, np.array([0.0, 0.0, 4.0]), lights)
        full = jb.angles_from_geometry_np(geom, tangent_frame=True)
        cols = {k: np.asarray(x) for k, x in full._asdict().items()}
    else:
        cols = angle_columns(rng, T, V, tangent=jb.MODELS[model].tangent)
    ja = jb.ShadingAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    true_p = np.stack([true_params(model, rng, T) for _ in range(C)], 1)
    inten = np.stack([np.asarray(jb.MODELS[model].fn(jnp.asarray(true_p[:, c]), ja))
                      for c in range(C)], -1)
    inten = (inten + rng.normal(0, 0.01, inten.shape)).astype(np.float32)
    weights = (rng.uniform(size=(T, V)) > 0.1).astype(np.float32)
    angles = jb.ShadingAngles(**cols)
    if with_geometry:
        angles = jb.ShadingAngles(*angles[:4])
    return JProblem(angles=angles, intensity=inten, weights=weights, face_ids=np.arange(T),
                    geometry=geom), true_p


@pytest.mark.parametrize("robust", [None, "huber"])
def test_fit_per_texel_matches_jax_fit_per_texel(robust):
    """Default engine on both sides: on a CPU mesh and a CPU device "auto" is
    the eager tier. Channels fold into the batch and come back as (T, C)."""
    model = "cook_torrance"
    problem, _ = _problem(model, seed=12)
    rj = j_fit_per_texel(problem, model, opts=JOptions(**OPTS), mesh=_mesh(), robust=robust)
    rt = fit_per_texel(convert.from_numpy(problem), model, opts=LMOptions(**OPTS), device="cpu",
                       robust=robust)
    assert rt.params.shape == (T, C, 3) and rt.result.stop.shape == (T, C)
    out = _outcome(rt.result, rj.result, 3)
    assert abs(out["conv_t"] - out["conv_j"]) <= 0.1, out
    assert out["chi2_close"] >= 0.85 and out["both"] >= 0.5 and out["p_close"] >= 0.85, out
    assert rt.converged_fraction() == pytest.approx(rj.converged_fraction(), abs=0.1)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_chunked_fit_equals_the_unchunked_fit(engine, tmp_path, monkeypatch):
    """Four chunks with a checkpoint after each, straight through and killed
    after two chunks and resumed: parameters, χ², stop codes, μ and ν equal
    the unchunked fit bit for bit, iterations add up. The iteration budget
    leaves some lanes unfinished on either tier."""
    model = "blinn_phong"
    problem, _ = _problem(model, seed=13)
    tp = convert.from_numpy(problem)
    chunk = 4 if engine == "pallas" else 1
    opts = LMOptions(**dict(OPTS, itmax=4 * chunk))
    whole = fit_per_texel(tp, model, opts=opts, device="cpu", engine=engine)
    assert (whole.result.stop == 3).any() and (whole.result.stop != 3).any()

    def same(rep):
        for f in ("p", "chi2", "stop", "mu", "nu", "iters", "njev", "nlss"):
            torch.testing.assert_close(getattr(rep.result, f), getattr(whole.result, f),
                                       rtol=0, atol=0, msg=f)

    straight = FitCheckpointer(str(tmp_path / "straight"))
    same(fit_per_texel(tp, model, opts=opts, device="cpu", engine=engine,
                       checkpointer=straight, chunk_iters=chunk))
    assert latest_step(straight.path) == 4 * chunk
    arrays, meta = load_fit_state(straight.path)
    assert meta["model"] == model and set(arrays) == set(LMResult._fields)
    assert arrays["p"].shape == (T * C, 3)

    killed = FitCheckpointer(str(tmp_path / "killed"))
    real, n = tpipe.fit_texels, []

    def dies_in_the_third_chunk(*a, **kw):
        if len(n) == 2:
            raise KeyboardInterrupt
        n.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "fit_texels", dies_in_the_third_chunk)
    with pytest.raises(KeyboardInterrupt):
        fit_per_texel(tp, model, opts=opts, device="cpu", engine=engine,
                      checkpointer=killed, chunk_iters=chunk)
    monkeypatch.setattr(tpipe, "fit_texels", real)
    assert latest_step(killed.path) == 2 * chunk
    resumed = fit_per_texel(tp, model, opts=opts, device="cpu", engine=engine,
                            checkpointer=killed, chunk_iters=chunk)
    same(resumed)
    # resume=False starts over and overwrites
    fresh = fit_per_texel(tp, model, opts=opts._replace(itmax=chunk), device="cpu",
                          engine=engine, checkpointer=killed, chunk_iters=chunk, resume=False)
    assert int(fresh.result.iters.max()) <= chunk


def test_chunked_fit_then_irls_rounds(tmp_path):
    """After a chunked fit the robust rounds refit from its parameters."""
    model = "blinn_phong"
    problem, _ = _problem(model, seed=14)
    tp = convert.from_numpy(problem)
    opts = LMOptions(**dict(OPTS, itmax=12))
    rep = fit_per_texel(tp, model, opts=opts, device="cpu", engine="pallas", robust="huber",
                        robust_iters=1, checkpointer=FitCheckpointer(str(tmp_path)),
                        chunk_iters=6)
    ref = fit_per_texel(tp, model, opts=opts, device="cpu", engine="pallas", robust="huber",
                        robust_iters=1)
    torch.testing.assert_close(rep.params, ref.params, rtol=0, atol=0)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint written by ``brdf_tpu.utils.checkpoint`` resumes the
    port's fit, and the JAX package reads the port's checkpoint."""
    model = "blinn_phong"
    problem, _ = _problem(model, seed=15)
    tp = convert.from_numpy(problem)
    opts = LMOptions(**dict(OPTS, itmax=12))
    whole = fit_per_texel(tp, model, opts=opts, device="cpu", engine="pallas")
    part = fit_per_texel(tp, model, opts=opts._replace(itmax=4), device="cpu", engine="pallas")
    theirs = j_ckpt.FitCheckpointer(str(tmp_path / "theirs"))
    theirs.maybe_save(4, {k: getattr(part.result, k).reshape(T * C, -1).squeeze(-1).numpy()
                          if k != "p" else part.result.p.numpy() for k in LMResult._fields},
                      {"model": model, "iters_done": 4})
    resumed = fit_per_texel(tp, model, opts=opts, device="cpu", engine="pallas",
                            checkpointer=FitCheckpointer(str(tmp_path / "theirs")), chunk_iters=4)
    for f in ("p", "chi2", "stop", "iters"):
        torch.testing.assert_close(getattr(resumed.result, f), getattr(whole.result, f),
                                   rtol=0, atol=0, msg=f)
    arrays_j, meta_j = j_ckpt.load_fit_state(str(tmp_path / "theirs"))
    arrays_t, meta_t = load_fit_state(str(tmp_path / "theirs"))
    assert meta_j == meta_t and meta_t["iters_done"] in (8, 12)
    for k in LMResult._fields:
        np.testing.assert_array_equal(arrays_j[k], arrays_t[k])
    # a checkpoint of another model or size is ignored, not loaded
    other = fit_per_texel(tp, "phong", opts=opts._replace(itmax=4), device="cpu", engine="pallas",
                          checkpointer=FitCheckpointer(str(tmp_path / "theirs")), chunk_iters=4)
    assert int(other.result.iters.max()) <= 4


def test_tangent_frame_angles_match_the_jax_package():
    rng = np.random.default_rng(16)
    points = rng.normal(size=(32, 3))
    normals = rng.normal(size=(32, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    normals[0] = [0.0, 0.0, -1.0 + 1e-9]          # near the frame's pole
    normals[0] /= np.linalg.norm(normals[0])
    eye, lights = np.array([0.1, -0.2, 5.0]), rng.normal(size=(V, 3)) * 3.0
    t_np, b_np = tangent_basis_np(normals)
    tj, bj = jb_tangent(normals)
    np.testing.assert_array_equal(t_np, tj)
    np.testing.assert_array_equal(b_np, bj)
    tt, bt = tangent_basis(torch.tensor(normals))
    np.testing.assert_allclose(tt.numpy(), t_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bt.numpy(), b_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.sum(t_np[1:] * normals[1:], -1), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.sum(t_np[1:] * b_np[1:], -1), 0.0, atol=1e-12)

    gj = jb.shading_geometry_np(points, normals, eye, lights)
    gt = tb.shading_geometry_np(points, normals, eye, lights)
    aj = jb.angles_from_geometry_np(gj, tangent_frame=True)
    at = tb.angles_from_geometry_np(gt, tangent_frame=True)
    a_torch = tb.shading_angles(torch.tensor(points), torch.tensor(normals), torch.tensor(eye),
                                torch.tensor(lights), tangent_frame=True)
    a_jax = jb.shading_angles(jnp.asarray(points), jnp.asarray(normals), jnp.asarray(eye),
                              jnp.asarray(lights), tangent_frame=True)
    for name in tb.ShadingAngles._fields:
        np.testing.assert_array_equal(getattr(at, name), np.asarray(getattr(aj, name)), err_msg=name)
        assert getattr(at, name).dtype == np.float32 and getattr(at, name).shape == (32, V)
        np.testing.assert_allclose(getattr(a_torch, name).numpy()[1:],
                                   np.asarray(getattr(a_jax, name))[1:], rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    assert tb.angles_from_geometry_np(gt).cos_th is None


def jb_tangent(normals):
    from brdf_tpu.models.normalmap import tangent_basis_np as j_tangent_basis_np

    return j_tangent_basis_np(normals)


def test_fit_per_texel_rebuilds_tangent_angles_from_geometry():
    """An anisotropic lobe on a problem whose angles lack the tangent
    channels: they are rebuilt from ``problem.geometry``, and the fit equals
    the one on angles built with ``tangent_frame=True``."""
    model = "ward_aniso"
    problem, _ = _problem(model, seed=17, with_geometry=True)
    assert problem.angles.cos_th is None
    tp = convert.from_numpy(problem)
    assert isinstance(tp.geometry, tb.ShadingGeometry)
    opts = LMOptions(**dict(OPTS, itmax=8))
    rep = fit_per_texel(tp, model, opts=opts, device="cpu", engine="pallas")
    full = tb.angles_from_geometry_np(convert.to_numpy(tp.geometry), tangent_frame=True)
    ref = fit_per_texel(tp._replace(angles=convert.from_numpy(full), geometry=None), model,
                        opts=opts, device="cpu", engine="pallas")
    torch.testing.assert_close(rep.params, ref.params, rtol=0, atol=0)
    assert rep.params.shape == (T, C, 5) and torch.isfinite(rep.result.chi2).all()
    rj = j_fit_per_texel(problem, model, opts=JOptions(**dict(OPTS, itmax=8)), mesh=_mesh(),
                         engine="pallas")
    out = _outcome(rep.result, rj.result, 5)
    assert out["chi2_close"] >= 0.85, out
    with pytest.raises(ValueError, match="tangent-frame"):
        fit_per_texel(tp._replace(geometry=None), model, opts=opts, device="cpu")
