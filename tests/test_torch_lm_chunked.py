"""The chunked LM tier (brdf_tpu_torch/ops/ne.py::lm_fit_chunked: K6's plain
version under the eager control loop, on the CPU) against
``lm_fit_pallas_chunked(interpret=True)`` of the JAX package on the same
numpy inputs, float32.

One iteration from the same start must agree closely. A whole solve is a
chain of accept decisions (``df > 0``) that flip on one ulp of χ² near the
floor, and the TPU kernel adds view chunks where the port adds views, so whole
solves are compared by outcome, as tests/test_torch_lm_fused.py does for the
fused tier. Within the port a resumed solve equals an uninterrupted one bit
for bit."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.ops.lm_pallas import lm_fit_pallas_chunked  # noqa: E402
from brdf_tpu.solver.init import linear_grid_init as j_grid_init  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS  # noqa: E402
from brdf_tpu_torch.ops import lm as k5, ne  # noqa: E402
from brdf_tpu_torch.parallel import fit as pfit  # noqa: E402
from brdf_tpu_torch.parallel.mesh import make_mesh, use_mesh  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions, levmar_bc  # noqa: E402
from torch_port_inputs import angle_columns, recovery, true_params  # noqa: E402

OPTS = dict(eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=40)
CONVERGED = (1, 2, 6)


def _problem(model, t, v, seed=0, noisy=False):
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v, tangent=J_MODELS[model].tangent)
    ja = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    true_p = true_params(model, rng, t)
    target = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), ja))
    if noisy:
        spec = MODELS[model]
        p0 = np.clip(true_p * rng.uniform(0.8, 1.25, true_p.shape), spec.lower, spec.upper)
        target = target + rng.normal(0, 0.02, target.shape)
    else:
        p0 = np.asarray(j_grid_init(model, ja, jnp.asarray(target)))
    return (ja, convert.from_numpy(JAngles(**cols)), target.astype(np.float32),
            p0.astype(np.float32), true_p)


def _both(model, ja, ta, target, p0, opts, weights=None, view_block=8):
    spec = MODELS[model]
    kw = dict(lower=tuple(spec.lower), upper=tuple(spec.upper))
    rj = lm_fit_pallas_chunked(model, ja, jnp.asarray(target), jnp.asarray(p0),
                               weights=None if weights is None else jnp.asarray(weights),
                               opts=JOptions(**opts), block_t=128, view_block=view_block,
                               interpret=True, **kw)
    rt = ne.lm_fit_chunked(model, ta, torch.tensor(target), torch.tensor(p0),
                           weights=None if weights is None else torch.tensor(weights),
                           opts=LMOptions(**opts), **kw)
    return rj, rt


def _rel_share(a, b, rtol, floor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(b), floor)
    if rel.ndim == 2:
        rel = rel.max(-1)
    return float((rel < rtol).mean())


@pytest.mark.parametrize("model", ["blinn_phong", "lambert", "cook_torrance", "ward_aniso"])
def test_one_iteration_matches_the_pallas_chunked_engine(model):
    """itmax=1 from the same start, T=192, V=16, with weights: stop codes,
    iteration counts and ν equal; parameters, χ², μ and g_inf within 1e-5
    relative on ≥ 99% of lanes for the power-law lobe and lambert, within
    1e-4 on ≥ 95% for the roughness lobes (ill-conditioned normal equations
    in float32: the bars tests/test_torch_lm_fused.py measured for K5)."""
    t = 192
    ja, ta, target, p0, _ = _problem(model, t, 16, seed=1, noisy=True)
    w = np.random.default_rng(2).uniform(0.3, 1.0, target.shape).astype(np.float32)
    rj, rt = _both(model, ja, ta, target, p0, dict(OPTS, itmax=1), weights=w)
    assert rt.p.shape == (t, MODELS[model].n_params) and rt.stop.dtype == torch.int32
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.stop.numpy(), np.asarray(rj.stop))
    np.testing.assert_array_equal(rt.nu.numpy(), np.asarray(rj.nu))
    rtol, share = (1e-5, 0.99) if model in ("blinn_phong", "lambert") else (1e-4, 0.95)
    assert _rel_share(rt.p.numpy(), rj.p, rtol, 1e-3) >= share
    assert _rel_share(rt.chi2.numpy(), rj.chi2, rtol, 1e-9) >= share
    assert _rel_share(rt.mu.numpy(), rj.mu, rtol, 1e-30) >= share
    assert _rel_share(rt.g_inf.numpy(), rj.g_inf, rtol, 1e-6) >= share


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "minnaert"])
def test_whole_solve_matches_the_pallas_chunked_engine_by_outcome(model):
    """Both sides converge the same share of lanes (within 0.05), their χ²
    floors agree, and the parameters of lanes both converged agree to 1e-3
    relative on ≥ 90% of them (the JAX tests' rtol for a changed summation
    order, tests/test_lm_chunked.py)."""
    ja, ta, target, p0, _ = _problem(model, 192, 16, seed=3)
    rj, rt = _both(model, ja, ta, target, p0, OPTS)
    conv_j, conv_t = np.isin(np.asarray(rj.stop), CONVERGED), np.isin(rt.stop.numpy(), CONVERGED)
    assert abs(conv_j.mean() - conv_t.mean()) <= 0.05
    cj, ct = np.asarray(rj.chi2), rt.chi2.numpy()
    assert np.isfinite(ct).all()
    assert np.median(ct) <= max(10 * np.median(cj), 1e-9)
    assert (ct <= np.maximum(10 * cj, 1e-8)).mean() >= 0.97
    both = conv_j & conv_t
    assert both.mean() >= 0.5
    assert _rel_share(rt.p.numpy()[both], np.asarray(rj.p)[both], 1e-3, 1e-3) >= 0.9


def test_chunked_follows_the_fused_tier():
    """The same LM in two tiers (tests/test_lm_chunked.py::
    test_chunked_matches_fused): on the CPU both run their plain versions,
    which differ in one product's association (``d·r·w`` against ``d·(r·w)``),
    so stop codes and iteration counts agree on ≥ 95% of lanes and, on those,
    the parameters to rtol 1e-3, atol 1e-4."""
    model = "blinn_phong"
    _, ta, target, p0, _ = _problem(model, 192, 16, seed=0)
    spec = MODELS[model]
    kw = dict(opts=LMOptions(**OPTS), lower=tuple(spec.lower), upper=tuple(spec.upper))
    y, start = torch.tensor(target), torch.tensor(p0)
    r_f = k5.lm_fit_fused(model, ta, y, start, **kw)
    r_c = ne.lm_fit_chunked(model, ta, y, start, **kw)
    same = ((r_f.stop == r_c.stop) & (r_f.iters == r_c.iters)).numpy()
    assert same.mean() >= 0.95
    np.testing.assert_allclose(r_c.p.numpy()[same], r_f.p.numpy()[same], rtol=1e-3, atol=1e-4)
    # explicit unit weights take the weighted variant and give the same fit
    r_w = ne.lm_fit_chunked(model, ta, y, start, weights=torch.ones_like(y), **kw)
    assert torch.equal(r_w.p, r_c.p) and torch.equal(r_w.iters, r_c.iters)


def test_warm_resume_in_two_chunks_equals_straight_through():
    """tests/test_lm_chunked.py::test_warm_resume_matches_straight_through,
    held tighter within the port: 5 iterations, then a resume from the
    returned (μ, ν, stop) with the lanes cut at MAX_ITERATIONS reopened, equals
    one run bit for bit; stopped lanes burn no iteration in the second chunk.
    Against the JAX engine's resumed fit: the bars of that test."""
    model = "blinn_phong"
    ja, ta, target, p0, _ = _problem(model, 128, 16, seed=7)
    spec = MODELS[model]
    kw = dict(lower=tuple(spec.lower), upper=tuple(spec.upper))
    y, start = torch.tensor(target), torch.tensor(p0)
    opts = LMOptions(**OPTS)
    full = ne.lm_fit_chunked(model, ta, y, start, opts=opts, **kw)
    r1 = ne.lm_fit_chunked(model, ta, y, start, opts=opts._replace(itmax=5), **kw)
    reopened = torch.where(r1.stop == 3, 0, r1.stop).to(torch.float32)
    r2 = ne.lm_fit_chunked(model, ta, y, r1.p, opts=opts._replace(itmax=35),
                           warm=(r1.mu, r1.nu, reopened), **kw)
    done = (r1.stop != 3).numpy()
    assert done.any() and (~done).any()
    assert (r2.iters.numpy()[done] == 0).all()
    assert torch.equal(r2.p[done], r1.p[done])
    for field in ("p", "chi2", "stop", "mu", "nu"):
        assert torch.equal(getattr(r2, field), getattr(full, field)), field
    cut = torch.tensor(~done)
    assert torch.equal(torch.where(cut, r1.iters + r2.iters, r1.iters), full.iters)
    assert np.isin(r2.stop.numpy(), CONVERGED).mean() > 0.95

    jkw = dict(block_t=128, view_block=8, interpret=True, **kw)
    j1 = lm_fit_pallas_chunked(model, ja, jnp.asarray(target), jnp.asarray(p0),
                               opts=JOptions(**dict(OPTS, itmax=5)), **jkw)
    j_reopened = np.where(np.asarray(j1.stop) == 3, 0, np.asarray(j1.stop)).astype(np.float32)
    j2 = lm_fit_pallas_chunked(model, ja, jnp.asarray(target), jnp.asarray(j1.p),
                               opts=JOptions(**dict(OPTS, itmax=60)),
                               warm=(j1.mu, j1.nu, jnp.asarray(j_reopened)), **jkw)
    np.testing.assert_allclose(r2.p.numpy(), np.asarray(j2.p), rtol=5e-3, atol=1e-3)


def test_256_views_match_the_eager_tier():
    """tests/test_lm_chunked.py::test_large_view_count_matches_lax_tier: a
    256-view rig (more than the fused kernel takes for a nine-channel
    lobe, and a whole warp a texel with its views staged in shared memory for
    this one) through the chunked tier and through ``levmar_bc``."""
    model = "cook_torrance"
    _, ta, target, p0, true_p = _problem(model, 96, 256, seed=2)
    spec = MODELS[model]
    assert not k5.fits_fused(9, 256) and k5.lane_layout(3, 256)[0] == 32
    assert k5.register_slots(3, k5.lane_layout(3, 256)[1]) == 0
    y, start = torch.tensor(target), torch.tensor(p0)
    r_c = ne.lm_fit_chunked(model, ta, y, start, opts=LMOptions(**OPTS),
                            lower=tuple(spec.lower), upper=tuple(spec.upper))

    def residual(p, data):
        a, yy = data
        return spec.fn(p, a) - yy

    r_x = levmar_bc(residual, start, spec.lower, spec.upper, data=(ta, y), opts=LMOptions(**OPTS))
    rec_c, rec_x = recovery(r_c.p.numpy(), true_p), recovery(r_x.p.numpy(), true_p)
    assert rec_c > 0.9
    assert rec_c >= rec_x - 0.05


def test_solve_damped_at_nine_parameters_against_numpy():
    """The unrolled Cholesky for m = 9 (and 4..8) in float64 against
    ``numpy.linalg.solve``; a matrix that is not positive definite flags its
    lane and gives a zero step."""
    rng = np.random.default_rng(5)
    for m in range(1, 10):
        lanes = 17
        j = rng.normal(size=(lanes, 3 * m, m))
        a = np.einsum("tnj,tnk->tjk", j, j) + 1e-3 * np.eye(m)
        g = rng.normal(size=(lanes, m))
        a[3] = -np.eye(m)                                   # not positive definite
        af = {(r, c): torch.tensor(a[:, r, c]) for r in range(m) for c in range(r, m)}
        dp, ok = k5._solve_damped(af, [torch.tensor(g[:, r]) for r in range(m)], m)
        got = torch.stack(dp, -1).numpy()
        good = np.arange(lanes) != 3
        ref = np.linalg.solve(a[good], -g[good][..., None])[..., 0]
        assert ok.numpy()[good].all()
        np.testing.assert_allclose(got[good], ref, rtol=1e-9, atol=1e-12)
        if m >= 4:                       # the Cholesky tier; Cramer solves an indefinite system
            assert not ok.numpy()[3] and (got[3] == 0).all()
    assert k5.MAX_SOLVE_PARAMS == 9 and k5.MAX_PARAMS == 5
    with pytest.raises(ValueError, match="m=10"):
        k5._solve_damped({}, [torch.zeros(1)], 10)


def test_fit_texels_routes_the_pallas_engine_by_view_count(monkeypatch):
    """``engine="pallas"``: the fused kernel while a block of it can stage the
    views, the chunked tier beyond, with the warm state carried in both."""
    model = "blinn_phong"
    _, ta, target, p0, _ = _problem(model, 24, 16, seed=9)
    calls = []
    real_fused, real_chunked = pfit.lm_fit_fused, pfit.lm_fit_chunked
    monkeypatch.setattr(pfit, "lm_fit_fused",
                        lambda *a, **kw: calls.append(("fused", kw["warm"])) or real_fused(*a, **kw))
    monkeypatch.setattr(pfit, "lm_fit_chunked",
                        lambda *a, **kw: calls.append(("chunked", kw["warm"])) or real_chunked(*a, **kw))
    opts = LMOptions(**dict(OPTS, itmax=3))
    y = torch.tensor(target)
    res = pfit.fit_texels(model, ta, y, opts=opts, engine="pallas", device="cpu")
    assert [c[0] for c in calls] == ["fused"]
    wide = type(ta)(*(None if a is None else a.repeat(1, 30) for a in ta))       # V = 480 > 454
    warm = (torch.full((24,), 0.5), torch.full((24,), 4.0), torch.zeros(24, dtype=torch.int32))
    res_w = pfit.fit_texels(model, wide, y.repeat(1, 30), opts=opts, engine="pallas",
                            warm_state=warm, robust="huber", robust_iters=1, device="cpu")
    assert [c[0] for c in calls] == ["fused", "chunked", "chunked"]
    assert torch.equal(calls[1][1][0], warm[0]) and calls[1][1][2].dtype == torch.float32
    assert res.p.shape == res_w.p.shape == (24, 3)
    assert bool((res_w.nfev == 2 * res_w.iters + 1).all())
    assert k5.fits_fused(2, 454) and not k5.fits_fused(2, 455)
    assert k5.fits_fused(9, 165) and not k5.fits_fused(9, 166)
    with pytest.raises(ValueError, match="lm_fit_chunked"):
        k5.lm_fit_fused(model, wide, y.repeat(1, 30), torch.tensor(p0))


def test_axis_name_and_bounds_are_checked():
    model = "blinn_phong"
    _, ta, target, p0, _ = _problem(model, 8, 4, seed=11)
    # an axis name needs a current mesh; over the 1 × 1 mesh its sums are the
    # identity (tests/test_torch_sharding.py runs real ones)
    with pytest.raises(ValueError, match="use_mesh"):
        ne.lm_fit_chunked(model, ta, torch.tensor(target), torch.tensor(p0), axis_name="view")
    plain = ne.lm_fit_chunked(model, ta, torch.tensor(target), torch.tensor(p0))
    with use_mesh(make_mesh(device="cpu")):
        named = ne.lm_fit_chunked(model, ta, torch.tensor(target), torch.tensor(p0),
                                  axis_name="view")
    for a, b in zip(plain, named):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="params"):
        ne.lm_fit_chunked(model, ta, torch.tensor(target), torch.tensor(p0), lower=(0.0,),
                          upper=(1.0,))
    before = ne.LOOP_SYNCS
    r = ne.lm_fit_chunked(model, ta, torch.tensor(target), torch.tensor(p0),
                          opts=LMOptions(**dict(OPTS, itmax=2)))
    assert ne.LOOP_SYNCS - before == int(r.iters.max()) + 1      # one test per pass, one to leave
