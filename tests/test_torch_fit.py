"""The slice as a whole: the port's ``fit_per_texel`` / ``fit_texels``
against the JAX package, on synthetic texels × 3 channels × 16 views.

Two references:
- the program the TPU runs for ``engine="varpro"``, composed here from
  ``varpro_fit_pallas(interpret=True)`` and ``robust_weights`` rounds;
- JAX ``pipeline.fit.fit_per_texel(engine="varpro")`` on a one-device CPU
  mesh, which runs the XLA tier with its own init (so it is held to
  ``tests/test_varpro.py``'s bar between the XLA tier and the kernel).

Lane-for-lane closeness of two float32 implementations of this solve is
bounded by the solve itself (see test_torch_varpro.py): the port is held to
its own agreement with itself under a one-ulp change of the intensities.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.ops.varpro_pallas import varpro_fit_pallas  # noqa: E402
from brdf_tpu.pipeline.fit import TexelProblem as JProblem  # noqa: E402
from brdf_tpu.solver.robust import robust_weights, saturation_weights  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import ShadingAngles as ShadingAnglesT  # noqa: E402
from brdf_tpu_torch.parallel import fit as tfit  # noqa: E402
from brdf_tpu_torch.parallel import fit_texels_sharded, make_mesh  # noqa: E402
from brdf_tpu_torch.pipeline.fit import FitReport, TexelProblem, fit_per_texel  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402
from torch_port_inputs import agreement, angle_columns, recovery, true_params  # noqa: E402

T, V, C = 96, 16, 3
# the solver settings of the timber-blinn and bunny-ct presets
PRESETS = {
    "timber-blinn": dict(model="blinn_phong", robust="huber", lower=None, upper=None),
    "bunny-ct": dict(model="cook_torrance", robust="huber",
                     lower=(0.0, 0.0, 1e-3), upper=(2.0, 2.0, 1.0)),
}


def _problem(model, seed=0):
    """Per-channel true parameters as in bench.py::make_problem."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, T, V)
    ja = JAngles(**cols)
    true_p = np.stack([true_params(model, rng, T) for _ in range(C)], 1)   # (T, C, 3)
    inten = np.stack([np.asarray(J_MODELS[model].fn(jnp.asarray(true_p[:, c]), ja))
                      for c in range(C)], -1).astype(np.float32)           # (T, V, C)
    weights = (rng.uniform(size=(T, V)) > 0.1).astype(np.float32)
    return JProblem(angles=ja, intensity=inten, weights=weights,
                    face_ids=np.arange(T)), true_p, rng


def _jax_reference(problem, model, robust, robust_iters, k, lower, upper):
    """What the TPU program computes: channel fold, saturation mask, the
    fused kernel with in-kernel grid init in every round, IRLS reweighting."""
    ang = jax.tree.map(lambda a: np.repeat(np.asarray(a), C, axis=0), problem.angles)
    y = np.asarray(problem.intensity).transpose(0, 2, 1).reshape(T * C, V)
    w = np.repeat(np.asarray(problem.weights), C, axis=0)
    w = w * np.asarray(saturation_weights(jnp.asarray(y)))
    kw = dict(iters=k, block_t=128, interpret=True,
              lower=None if lower is None else tuple(lower),
              upper=None if upper is None else tuple(upper))
    r = varpro_fit_pallas(model, ang, jnp.asarray(y), weights=jnp.asarray(w), **kw)
    for _ in range(robust_iters):
        w_i = robust_weights(J_MODELS[model].fn(r.p, ang) - y, jnp.asarray(w), kind=robust)
        r = varpro_fit_pallas(model, ang, jnp.asarray(y), weights=w_i, **kw)
    return r


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fit_per_texel_matches_the_tpu_program(preset, monkeypatch):
    cfg = PRESETS[preset]
    model = cfg["model"]
    problem, true_p, rng = _problem(model, seed=len(preset))
    opts = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=60)   # k = min(60, 16)

    calls = []
    real = tfit.varpro_fit_fused
    monkeypatch.setattr(tfit, "varpro_fit_fused",
                        lambda *a, **kw: calls.append(kw.get("p0")) or real(*a, **kw))
    rep = fit_per_texel(convert.from_numpy(problem), model, opts=opts, device="cpu",
                        engine="varpro", robust=cfg["robust"], robust_iters=2,
                        lower=cfg["lower"], upper=cfg["upper"])
    # one fused solve per round, each with its in-kernel grid init
    assert calls == [None, None, None]
    rj = _jax_reference(problem, model, cfg["robust"], 2, 16, cfg["lower"], cfg["upper"])

    assert isinstance(rep, FitReport) and rep.params.shape == (T, C, 3)
    assert rep.result.chi2.shape == (T, C) and rep.result.p.shape == (T * C, 3)
    np.testing.assert_array_equal(rep.result.nfev.numpy(), 17)
    np.testing.assert_array_equal(rep.result.njev.numpy(), 16)
    np.testing.assert_array_equal(rep.result.nlss.numpy(), 16)
    assert float(rep.result.mu.abs().max()) == 0.0
    pt = rep.params.numpy().reshape(T * C, 3)
    pj = np.asarray(rj.p)
    tp = true_p.reshape(T * C, 3)
    assert abs(recovery(pt, tp) - recovery(pj, tp)) <= 0.03
    np.testing.assert_array_equal(
        np.isin(rep.result.stop.numpy().ravel(), (2, 3)), True)

    bumped = np.asarray(problem.intensity).copy()
    bump = rng.choice([-1.0, 0.0, 1.0], bumped.shape).astype(np.float32)
    bumped = np.where(bump == 0, bumped,
                      np.nextafter(bumped, np.copysign(np.float32(np.inf), bump)))
    rep_ulp = fit_per_texel(convert.from_numpy(problem._replace(intensity=bumped)), model,
                            opts=opts, device="cpu", engine="varpro", robust=cfg["robust"],
                            robust_iters=2, lower=cfg["lower"], upper=cfg["upper"])
    pu = rep_ulp.params.numpy().reshape(T * C, 3)
    # 0.05 ≈ three standard deviations of a share estimated on 288 lanes
    for rtol in (1e-4, 1e-2):
        assert agreement(pt, pj, rtol) >= agreement(pu, pt, rtol) - 0.05


def test_fit_per_texel_matches_jax_pipeline_xla_tier():
    """The JAX pipeline on a one-device CPU mesh runs the XLA tier (refined
    16-point init), so the bar is tests/test_varpro.py's between that tier
    and the fused kernel: equal recovery, 90% of lanes within 1e-3."""
    from brdf_tpu.parallel.mesh import make_mesh
    from brdf_tpu.pipeline.fit import fit_per_texel as j_fit_per_texel
    from brdf_tpu.solver.lm import LMOptions as JOptions

    problem, true_p, _ = _problem("blinn_phong", seed=7)
    opts = dict(eps1=1e-9, eps2=1e-9, eps3=1e-14, itmax=8)
    mesh = make_mesh(data=1, view=1, devices=jax.devices()[:1])
    rj = j_fit_per_texel(problem, "blinn_phong", opts=JOptions(**opts), mesh=mesh,
                         engine="varpro")
    rt = fit_per_texel(convert.from_numpy(problem), "blinn_phong", opts=LMOptions(**opts),
                       device="cpu", engine="varpro")
    pj, pt = np.asarray(rj.params), rt.params.numpy()
    tp = true_p
    assert abs(recovery(pt.reshape(-1, 3), tp.reshape(-1, 3))
               - recovery(pj.reshape(-1, 3), tp.reshape(-1, 3))) < 0.02
    close = np.isclose(pt, pj, rtol=1e-3, atol=1e-3).all(-1)
    assert close.mean() > 0.9
    assert rt.converged_fraction() == pytest.approx(rj.converged_fraction(), abs=0.05)
    assert set(rt.chi2_summary()) == set(rj.chi2_summary())


def test_p0_resume_from_a_jax_result():
    """A start taken from a JAX fit, carried through convert, resumes the
    port's fit exactly as it resumes the JAX kernel: one more chunk of
    Newton steps from the same parameters."""
    problem, true_p, _ = _problem("blinn_phong", seed=3)
    ang = JAngles(**{k: np.asarray(getattr(problem.angles, k))
                     for k in ("cos_ln", "cos_nh", "cos_rv", "cos_vn")})
    y = np.asarray(problem.intensity)[..., 0]
    r_a = varpro_fit_pallas("blinn_phong", ang, jnp.asarray(y), iters=3, block_t=128,
                            interpret=True)
    r_ab = varpro_fit_pallas("blinn_phong", ang, jnp.asarray(y), p0=r_a.p, iters=3,
                             block_t=128, interpret=True)
    p0 = convert.from_numpy(r_a.p)
    assert p0.dtype == torch.float32
    rt = tfit.fit_texels("blinn_phong", convert.from_numpy(ang), torch.tensor(y),
                         opts=LMOptions(itmax=3), p0=p0, device="cpu")
    c_a = float(np.median(np.asarray(r_a.chi2)))
    assert float(rt.chi2.median()) <= c_a
    assert abs(recovery(rt.p.numpy(), true_p[:, 0]) - recovery(np.asarray(r_ab.p), true_p[:, 0])) <= 0.03
    assert agreement(rt.p.numpy(), np.asarray(r_ab.p), 1e-2) >= 0.9


def test_convert_round_trips_the_fit_state():
    problem, _, _ = _problem("ward", seed=1)
    tp = convert.from_numpy(problem)
    assert isinstance(tp, TexelProblem) and isinstance(tp.face_ids, np.ndarray)
    assert tp.intensity.dtype == torch.float32 and tp.intensity.shape == (T, V, C)
    back = convert.to_numpy(tp)
    np.testing.assert_array_equal(back.intensity, problem.intensity)
    np.testing.assert_array_equal(back.angles.cos_nh, np.asarray(problem.angles.cos_nh))
    warm = (np.zeros(4, np.float32), np.full(4, 2.0, np.float32), np.zeros(4, np.int32))
    t_warm = convert.from_numpy(warm)
    assert t_warm[2].dtype == torch.int32
    for a, b in zip(convert.to_numpy(t_warm), warm):
        np.testing.assert_array_equal(a, b)


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    problem, _, _ = _problem("blinn_phong", seed=2)
    tp = convert.from_numpy(problem)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_per_texel(tp, "blinn_phong")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.fit_texels("blinn_phong", tp.angles, tp.intensity[..., 0])


def test_later_slices_raise_not_implemented():
    """Every engine now takes what it took in the JAX package: the LM
    engines any lobe (test_torch_fit_lm.py), ``engine="varpro"`` every
    separable lobe, the m ≥ 4 ones too (test_torch_fit_varpro_nd.py), and
    the fits take a mesh (tests/test_torch_sharding.py): over the 1 × 1 mesh
    of one process they are the device's fits, bit for bit. What neither
    package fits still raises."""
    problem, _, _ = _problem("blinn_phong", seed=2)
    tp = convert.from_numpy(problem)
    ang, y = tp.angles, tp.intensity[..., 0]
    mesh = make_mesh(device="cpu")
    assert (mesh.data, mesh.view, mesh.world, mesh.coords) == (1, 1, 1, (0, 0))
    for engine in ("xla", "pallas", "varpro"):
        one = tfit.fit_texels("blinn_phong", ang, y, opts=LMOptions(itmax=3), engine=engine,
                              robust="huber", robust_iters=1, device="cpu")
        meshed = fit_texels_sharded("blinn_phong", ang, y, mesh, opts=LMOptions(itmax=3),
                                    engine=engine, robust="huber", robust_iters=1)
        assert all(torch.equal(a, b) for a, b in zip(one, meshed)), engine
    rep = fit_per_texel(tp, "blinn_phong", opts=LMOptions(itmax=3), mesh=mesh)
    ref = fit_per_texel(tp, "blinn_phong", opts=LMOptions(itmax=3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(rep.result, ref.result))
    with pytest.raises(ValueError, match="not both"):
        fit_per_texel(tp, "blinn_phong", device="cpu", mesh=mesh)
    for engine in ("auto", "pallas", "xla"):
        res = tfit.fit_texels("blinn_phong", ang, y, opts=LMOptions(itmax=2), engine=engine,
                              device="cpu")
        assert res.p.shape == (T, 3)
    # the anisotropic lobes read the six tangent-frame channels
    rng = np.random.default_rng(4)
    tangent = {k: torch.tensor(rng.uniform(-1.0, 1.0, (T, V)), dtype=torch.float32)
               for k in ("cos_th", "cos_bh", "cos_tl", "cos_bl", "cos_tv", "cos_bv")}
    ang_t = ang._replace(**tangent)
    for model in ("cook_torrance_fresnel", "ward_aniso", "cook_torrance_aniso"):
        res = tfit.fit_texels(model, ang_t, y, opts=LMOptions(itmax=2), engine="varpro",
                              device="cpu")
        m = J_MODELS[model].n_params
        assert res.p.shape == (T, m) and res.chi2.shape == (T,)
        assert bool(torch.isfinite(res.chi2).all()) and bool(torch.isfinite(res.p).all())
        np.testing.assert_array_equal(res.nfev.numpy(), 3)
    with pytest.raises(ValueError, match="separable"):
        tfit.fit_texels("lambert", ang, y, engine="varpro", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tfit.fit_texels("lambert", ang, y, engine="mosaic", device="cpu")
    # a view count the fused LM kernel cannot hold goes to the chunked tier
    wide = ShadingAnglesT(*(None if a is None else a.repeat(1, 400) for a in ang))
    res = tfit.fit_texels("blinn_phong", wide, y.repeat(1, 400), opts=LMOptions(itmax=2),
                          engine="pallas", device="cpu")
    assert res.p.shape == (T, 3) and bool((res.iters <= 2).all())
    with pytest.raises(ValueError, match="tangent-frame"):
        fit_per_texel(tp, "ward_aniso", device="cpu")
