"""``fit_joint_normalmap`` and ``fit_joint_normalmap_with_gains`` of the port
(brdf_tpu_torch/pipeline/fit.py, ``device="cpu"``: the "pallas" engine runs
K7's plain version under the eager LM loop) against the JAX package on
tests/test_joint_pallas.py's problem, from the same numpy arrays.

A joint solve is a chain of accept decisions at one ulp, so fits are compared
by outcome (median χ², which texels converge, the fitted normals), with the
bars of tests/test_joint_pallas.py and tests/test_varpro_joint.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models import brdf as jb  # noqa: E402
from brdf_tpu.models import normalmap as jn  # noqa: E402
from brdf_tpu.pipeline import fit as j_fit  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models import normalmap as tn  # noqa: E402
from brdf_tpu_torch.models.brdf import ShadingGeometry  # noqa: E402
from brdf_tpu_torch.ops import ne  # noqa: E402
from brdf_tpu_torch.pipeline import fit as t_fit  # noqa: E402
from brdf_tpu_torch.pipeline.fit import (  # noqa: E402
    FitReport,
    fit_joint_normalmap,
    fit_joint_normalmap_with_gains,
    fit_quality_metrics,
)
from brdf_tpu_torch.solver.lm import LMOptions, LMResult  # noqa: E402
from torch_port_inputs import joint_problem  # noqa: E402

OPTS = dict(eps1=1e-8, eps2=1e-8, eps3=1e-16, itmax=80)


def _problems(t, v=16, seed=0, base="cook_torrance", clip=None):
    """One numpy problem as a ``TexelProblem`` of either package."""
    geom, true_p, rng = joint_problem(t, v, seed, base)
    jg = jb.ShadingGeometry(**{k: jnp.asarray(x) for k, x in geom.items()})
    target = np.asarray(jn.joint_eval(jn.joint_spec(base), jnp.asarray(true_p), jg))
    if clip is not None:
        target = np.clip(target, 0.0, clip)
    return geom, jg, true_p, target, rng


def _j_problem(jg, target, tangent=False):
    return j_fit.TexelProblem(angles=jb.angles_from_geometry(jg, tangent_frame=tangent),
                              intensity=jnp.asarray(target),
                              weights=jnp.ones(target.shape[:2], jnp.float32),
                              face_ids=np.arange(target.shape[0]), geometry=jg)


def _t_problem(geom, target, tangent=False, weights=None):
    """numpy leaves, as ``build_face_problem`` hands them over."""
    g = ShadingGeometry(**geom)
    from brdf_tpu_torch.models.brdf import angles_from_geometry_np
    return t_fit.TexelProblem(
        angles=angles_from_geometry_np(g, tangent_frame=tangent), intensity=target,
        weights=np.ones(target.shape[:2], np.float32) if weights is None else weights,
        face_ids=np.arange(target.shape[0]), geometry=g)


def _normal_err_deg(n, p, true_p):
    t_, b_ = tn.tangent_basis_np(n)

    def normals_of(q):
        nn = n + q[:, 7, None] * t_ + q[:, 8, None] * b_
        return nn / np.linalg.norm(nn, axis=-1, keepdims=True)

    cos = (normals_of(np.asarray(true_p)) * normals_of(np.asarray(p))).sum(-1)
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


@pytest.fixture(scope="module")
def engines():
    """tests/test_joint_pallas.py::test_fit_joint_normalmap_engine_parity's
    problem (T=48, grid-init start) through the three engines of the port and
    through the JAX package's "xla" engine."""
    t = 48
    geom, jg, true_p, target, _ = _problems(t, seed=4)
    res_j, spec_j = j_fit.fit_joint_normalmap(_j_problem(jg, target), opts=JOptions(**OPTS),
                                              engine="xla")
    prob = _t_problem(geom, target)
    out = {"jax": res_j, "spec_j": spec_j, "true_p": true_p, "geom": geom}
    for engine in ("pallas", "xla", "varpro"):
        out[engine], out["spec"] = fit_joint_normalmap(prob, opts=LMOptions(**OPTS), engine=engine,
                                                       device="cpu")
    return out


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_lm_engines_agree_with_the_jax_xla_engine(engines, engine):
    """Median χ² < 1e-8 on both sides, more than half the texels converge, and
    the converged sets differ on ≤ 0.1 of the lanes."""
    res, ref = engines[engine], engines["jax"]
    assert isinstance(res, LMResult) and res.p.shape == (48, 9) and res.p.dtype == torch.float32
    assert engines["spec"] == convert.from_numpy(engines["spec_j"]) == tn.joint_spec("cook_torrance")
    chi2, chi2_j = res.chi2.numpy(), np.asarray(ref.chi2)
    assert np.isfinite(chi2).all()
    assert np.median(chi2) < 1e-8 and np.median(chi2_j) < 1e-8
    conv, conv_j = chi2 < 1e-8, chi2_j < 1e-8
    assert conv.mean() > 0.5
    assert (conv ^ conv_j).mean() <= 0.1
    both = conv & conv_j
    np.testing.assert_allclose(res.p.numpy()[both], np.asarray(ref.p)[both], rtol=5e-2, atol=5e-3)
    lo, hi = np.asarray(engines["spec"].lower), np.asarray(engines["spec"].upper)
    assert ((res.p.numpy() >= lo - 1e-6) & (res.p.numpy() <= hi + 1e-6)).all()
    ang = _normal_err_deg(engines["geom"]["n"], res.p.numpy(), engines["true_p"])
    assert np.median(ang[conv]) < 0.5
    back = convert.from_numpy(convert.to_numpy(res))
    assert isinstance(back, LMResult) and torch.equal(back.p, res.p)
    assert isinstance(convert.from_numpy(ref), LMResult) and convert.from_numpy(ref).p.shape == (48, 9)


def test_the_engines_of_the_port_agree_with_each_other(engines):
    r_p, r_x, r_v = engines["pallas"], engines["xla"], engines["varpro"]
    conv_p, conv_x = (r_p.chi2 < 1e-8).numpy(), (r_x.chi2 < 1e-8).numpy()
    assert (conv_p ^ conv_x).mean() <= 0.1
    assert bool((r_p.nfev == 2 * r_p.iters + 1).all()) and r_p.iters.dtype == torch.int32
    # the VarPro tier: 12 fixed steps, a deeper median than either LM tier needs
    assert r_v.p.shape == (48, 9) and torch.isfinite(r_v.chi2).all()
    assert float(r_v.chi2.median()) < 1e-6
    assert bool((r_v.nfev == 13).all()) and bool((r_v.njev == 12).all())
    ang_v = _normal_err_deg(engines["geom"]["n"], r_v.p.numpy(), engines["true_p"])
    ang_p = _normal_err_deg(engines["geom"]["n"], r_p.p.numpy(), engines["true_p"])
    assert np.median(ang_v) < max(3 * np.median(ang_p), 0.5)


def test_a_channel_report_is_the_start_and_auto_is_xla_on_the_cpu():
    """From per-channel parameters near the truth the fit converges nearly
    everywhere (tests/test_joint_pallas.py::test_joint_chunked_matches_xla_tier's
    start); ``engine="auto"`` on the CPU is the eager tier."""
    t = 32
    geom, jg, true_p, target, rng = _problems(t, seed=3)
    chan = np.stack([np.stack([true_p[:, c], true_p[:, 3 + c], true_p[:, 6]], -1)
                     for c in range(3)], 1) * rng.uniform(0.9, 1.1, (t, 3, 3)).astype(np.float32)
    report = FitReport(params=torch.tensor(chan), face_ids=np.arange(t), result=None,
                       model="cook_torrance")
    prob = _t_problem(geom, target)
    before = ne.LOOP_SYNCS
    res_a, _ = fit_joint_normalmap(prob, opts=LMOptions(**OPTS), channel_report=report, device="cpu")
    assert ne.LOOP_SYNCS == before                       # "auto" took no pass of the chunked loop
    res_p, _ = fit_joint_normalmap(prob, opts=LMOptions(**OPTS), channel_report=report,
                                   engine="pallas", device="cpu")
    assert ne.LOOP_SYNCS > before
    for res in (res_a, res_p):
        chi2 = res.chi2.numpy()
        assert np.median(chi2) < 1e-9 and (chi2 < 1e-9).mean() > 0.8
    both = ((res_a.chi2 < 1e-9) & (res_p.chi2 < 1e-9)).numpy()
    np.testing.assert_allclose(res_p.p.numpy()[both], res_a.p.numpy()[both], rtol=5e-2, atol=5e-3)
    with pytest.raises(ValueError, match="with_geometry"):
        fit_joint_normalmap(prob._replace(geometry=None), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        fit_joint_normalmap(prob, engine="mosaic", device="cpu")


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_joint_per_channel_saturation_mask(engine):
    """tests/test_joint_pallas.py's test of the same name: poisoning channel-2
    values that sit at the sensor ceiling changes nothing (array equality),
    and with the mask off it does."""
    t = 48
    geom, _, _, target, _ = _problems(t, seed=6, clip=0.95)
    sat = target.copy()
    sat[:, 10:, 2] = 0.99
    poisoned = sat.copy()
    poisoned[:, 10:, 2] = 123.0
    kw = dict(opts=LMOptions(**dict(OPTS, itmax=40)), engine=engine, device="cpu")
    r_sat, _ = fit_joint_normalmap(_t_problem(geom, sat), mask_saturation=True, **kw)
    r_poi, _ = fit_joint_normalmap(_t_problem(geom, poisoned), mask_saturation=True, **kw)
    assert torch.equal(r_sat.p, r_poi.p)
    r_off, _ = fit_joint_normalmap(_t_problem(geom, poisoned), mask_saturation=False, **kw)
    assert not torch.equal(r_off.p, r_poi.p)
    # a (T, V, 3) weight stack is taken as it is
    w3 = np.ones(target.shape, np.float32)
    w3[:, 10:, 2] = 0.0
    r_w3, _ = fit_joint_normalmap(_t_problem(geom, poisoned, weights=w3), mask_saturation=False, **kw)
    assert torch.equal(r_w3.p, r_poi.p)


def test_joint_irls_rejects_poisoned_view():
    """tests/test_joint_pallas.py's test of the same name, through the "pallas"
    engine: a grossly wrong view below the ceiling is downweighted, and the
    robust fit explains the clean views far better. The JAX package's robust
    fit ("xla") brings as many texels below 1e-6 on the clean views, within
    0.1 (about half of them get there, so a median would sit on the edge)."""
    t = 48
    geom, jg, _, target, _ = _problems(t, seed=7, clip=0.9)
    poisoned = target.copy()
    poisoned[:, 5, :] = 0.93
    opts = dict(OPTS, itmax=40)
    prob = _t_problem(geom, poisoned)
    r_rob, spec = fit_joint_normalmap(prob, opts=LMOptions(**opts), engine="pallas", robust="tukey",
                                      robust_iters=2, device="cpu")
    r_raw, _ = fit_joint_normalmap(prob, opts=LMOptions(**opts), engine="pallas", device="cpu")
    j_rob, _ = j_fit.fit_joint_normalmap(_j_problem(jg, poisoned), opts=JOptions(**opts),
                                         engine="xla", robust="tukey", robust_iters=2)
    tg = ShadingGeometry(**{k: torch.tensor(x) for k, x in geom.items()})
    keep = np.ones(16, bool)
    keep[5] = False

    def chi2_clean(p):
        r = tn.joint_eval(spec, torch.as_tensor(np.asarray(p)), tg).numpy() - target
        return (r[:, keep] ** 2).sum((1, 2))

    c_rob, c_raw, c_j = chi2_clean(r_rob.p), chi2_clean(r_raw.p), chi2_clean(j_rob.p)
    assert np.median(c_rob) < np.median(c_raw) * 0.5
    assert abs((c_rob < 1e-6).mean() - (c_j < 1e-6).mean()) <= 0.1
    assert (c_rob < 1e-6).mean() > (c_raw < 1e-6).mean() + 0.2


def test_fit_joint_normalmap_aniso_base():
    """The m = 11 fit around an anisotropic base: "xla" (and so "auto") runs it,
    "pallas" and "varpro" refuse the layout, as in the JAX package."""
    t = 24
    geom, _, _ = joint_problem(t, 16, 8)
    rng = np.random.default_rng(8)
    true_p = np.zeros((t, 11), np.float32)
    true_p[:, 0:3] = rng.uniform(0.2, 0.8, (t, 3))
    true_p[:, 3:6] = rng.uniform(0.3, 0.9, (t, 3))
    true_p[:, 6:8] = rng.uniform(0.3, 0.7, (t, 2))
    true_p[:, 8] = rng.uniform(-1.0, 1.0, t)
    true_p[:, 9:11] = rng.uniform(-0.2, 0.2, (t, 2))
    jg = jb.ShadingGeometry(**{k: jnp.asarray(x) for k, x in geom.items()})
    jspec = jn.joint_spec("cook_torrance_aniso", max_tilt=0.6)
    target = np.clip(np.asarray(jn.joint_eval(jspec, jnp.asarray(true_p), jg)), 0.0, 0.95)
    prob = _t_problem(geom, target, tangent=True)
    opts = dict(OPTS, itmax=40)
    res, spec = fit_joint_normalmap(prob, "cook_torrance_aniso", opts=LMOptions(**opts), device="cpu")
    assert spec.n_params == 11 and spec == convert.from_numpy(jspec)
    assert res.p.shape == (t, 11) and torch.isfinite(res.chi2).all()
    ref, _ = j_fit.fit_joint_normalmap(_j_problem(jg, target, tangent=True), "cook_torrance_aniso",
                                       opts=JOptions(**opts), engine="xla")
    assert float(res.chi2.median()) < 1e-4
    assert float(res.chi2.median()) < max(10 * float(np.median(np.asarray(ref.chi2))), 1e-6)
    for engine in ("pallas", "varpro"):
        with pytest.raises(ValueError, match="m=9"):
            fit_joint_normalmap(prob, "cook_torrance_aniso", opts=LMOptions(**opts), engine=engine,
                                device="cpu")


def test_joint_fit_with_view_gains_recovers_rig():
    """tests/test_joint_pallas.py's test of the same name through the "pallas"
    engine: the fitted gains track a known non-uniform rig (correlation > 0.8)
    and are the JAX package's ("xla") within 0.05; the median χ² of the fit
    with gains is well below that of the fit without (the mean error over all
    texels, which that test compares on its own data, is set by the few
    texels either package strands on this one)."""
    t = 192
    geom, jg, _, target, rng = _problems(t, seed=9, clip=0.9)
    true_g = rng.uniform(0.8, 1.25, 16).astype(np.float32)
    true_g /= true_g.mean()
    scaled = target * true_g[None, :, None]
    opts = dict(OPTS, itmax=40)
    prob = _t_problem(geom, scaled)
    res_g, spec, gains = fit_joint_normalmap_with_gains(prob, rounds=2, opts=LMOptions(**opts),
                                                        engine="pallas", device="cpu")
    assert gains.shape == (16,) and gains.dtype == np.float64 and res_g.p.shape == (t, 9)
    assert spec == tn.joint_spec("cook_torrance")
    assert np.corrcoef(gains, true_g)[0, 1] > 0.8, (gains, true_g)
    assert gains.min() >= 0.5 / gains.mean() - 1e-9 and abs(gains.mean() - 1.0) < 0.2
    _, _, gains_j = j_fit.fit_joint_normalmap_with_gains(
        _j_problem(jg, scaled), rounds=2, opts=JOptions(**opts), engine="xla")
    np.testing.assert_allclose(gains, gains_j, atol=0.05)
    res_0, _ = fit_joint_normalmap(prob, opts=LMOptions(**opts), engine="pallas", device="cpu")
    assert float(res_g.chi2.median()) < 0.5 * float(res_0.chi2.median())


def test_fit_quality_metrics_of_a_joint_fit_match_jax(engines):
    """``joint_normals=True``: the same keys, numbers and warnings as the JAX
    package gives for the per-channel view of a joint fit; the flag only drops
    the hint to refit with the joint tier from the pinned-parameter warning."""
    geom, jg, _, target, _ = _problems(48, seed=4)
    p = engines["pallas"].p.numpy()
    chan = np.stack([np.stack([p[:, c], p[:, 3 + c], p[:, 6]], -1) for c in range(3)], 1)
    bad = chan.copy()
    bad[:, :, 1] = 100.0                                   # ks pinned at its upper bound
    prob, j_prob = _t_problem(geom, target), _j_problem(jg, target)
    for params in (chan, bad):
        for joint in (True, False):
            got = fit_quality_metrics(prob, params, "cook_torrance", joint_normals=joint,
                                      chi2=engines["pallas"].chi2, device="cpu")
            ref = j_fit.fit_quality_metrics(j_prob, params, "cook_torrance", joint_normals=joint,
                                            chi2=np.asarray(engines["pallas"].chi2))
            assert got.keys() == ref.keys()
            assert got["warnings"] == ref["warnings"] and got["fraction_at_bounds"] == ref["fraction_at_bounds"]
            np.testing.assert_allclose(got["reprojection_mae"], ref["reprojection_mae"], rtol=1e-4,
                                       atol=1e-7)
    pinned = [w for w in got["warnings"] if "UPPER" in w]
    assert pinned and all("joint normal-map tier" in w for w in pinned)          # joint=False
    got_joint = fit_quality_metrics(prob, bad, "cook_torrance", joint_normals=True, device="cpu")
    pinned = [w for w in got_joint["warnings"] if "UPPER" in w]
    assert pinned and not any("joint normal-map tier" in w for w in pinned)
