"""The fused LM tier (brdf_tpu_torch/ops/lm.py: K5's plain version on the
CPU) against ``lm_fit_pallas(interpret=True)`` of the JAX package, on the
same numpy inputs, float32, T=256 texels × 16 views.

One iteration from the same start must agree closely. A full solve is a
chain of accept/reject decisions that flip on one ulp of χ² near
convergence (XLA's and torch's exp/log differ by an ulp), so full solves
are compared by outcome (χ² and parameters of lanes that both sides
converged), not by trajectory. Within the port a resumed solve equals an
uninterrupted one bit for bit."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.ops.lm_pallas import lm_fit_pallas, lm_fit_pallas_compacted  # noqa: E402
from brdf_tpu.solver.init import linear_grid_init as j_grid_init  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS  # noqa: E402
from brdf_tpu_torch.ops import lm as k5  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, StopReason  # noqa: E402
from torch_port_inputs import ALL_LOBES, angle_columns, true_params  # noqa: E402

T, V = 256, 16
OPTS = dict(eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=40)
CONVERGED = (1, 2, 6)


def _problem(model, seed=0, t=T, noisy=False):
    """Exact targets and the grid-init start; ``noisy`` instead adds N(0, 0.02)
    to the targets and starts 20% off the truth, so that one step is a
    well-conditioned move and χ² stays well above the float32 floor."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, V, tangent=J_MODELS[model].tangent)
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


def _both(model, ja, ta, target, p0, opts, weights=None, warm=None, lower=None, upper=None):
    spec = MODELS[model]
    lower = tuple(spec.lower if lower is None else lower)
    upper = tuple(spec.upper if upper is None else upper)
    rj = lm_fit_pallas(model, ja, jnp.asarray(target), jnp.asarray(p0),
                       weights=None if weights is None else jnp.asarray(weights),
                       opts=JOptions(**opts), lower=lower, upper=upper, block_t=128,
                       interpret=True,
                       warm=None if warm is None else tuple(jnp.asarray(x) for x in warm))
    rt = k5.lm_fit_fused(model, ta, torch.tensor(target), torch.tensor(p0),
                         weights=None if weights is None else torch.tensor(weights),
                         opts=LMOptions(**opts), lower=lower, upper=upper,
                         warm=None if warm is None else tuple(torch.tensor(x) for x in warm))
    return rj, rt


def _rel_share(a, b, rtol, floor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(b), floor)
    if rel.ndim == 2:
        rel = rel.max(-1)
    return float((rel < rtol).mean())


# lobes whose one step is exp/log and a well-conditioned 1×1..3×3 solve
TIGHT = ("phong", "blinn_phong", "lambert")


@pytest.mark.parametrize("model", ALL_LOBES)
def test_one_iteration_matches_the_pallas_kernel(model):
    """itmax=1 from the same start: one Jacobian pass, one damped solve, one
    accept decision. Stop codes, iteration counts and ν are equal;
    parameters, χ², μ and g_inf agree to 1e-5 relative on ≥ 99% of lanes
    for the power-law lobes and lambert. The roughness lobes' normal
    equations are ill-conditioned in float32, so there the measured bar is
    1e-4 relative on ≥ 95% of lanes (measured at T=256, two seeds: parameters
    ≥ 0.996, μ ≥ 0.992, χ² ≥ 0.961)."""
    ja, ta, target, p0, _ = _problem(model, seed=1, noisy=True)
    rj, rt = _both(model, ja, ta, target, p0, dict(OPTS, itmax=1))
    assert rt.p.shape == (T, MODELS[model].n_params) and rt.stop.dtype == torch.int32
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.stop.numpy(), np.asarray(rj.stop))
    np.testing.assert_array_equal(rt.nu.numpy(), np.asarray(rj.nu))
    assert 0.5 < (rt.nu.numpy() == 2.0).mean()          # most lanes accepted their step
    rtol, share = (1e-5, 0.99) if model in TIGHT else (1e-4, 0.95)
    assert _rel_share(rt.p.numpy(), rj.p, rtol, 1e-3) >= share
    assert _rel_share(rt.chi2.numpy(), rj.chi2, rtol, 1e-9) >= share
    assert _rel_share(rt.mu.numpy(), rj.mu, rtol, 1e-30) >= share
    assert _rel_share(rt.g_inf.numpy(), rj.g_inf, rtol, 1e-6) >= share


@pytest.mark.parametrize("model", ALL_LOBES)
def test_full_solve_matches_the_pallas_kernel_by_outcome(model):
    """Measured at T=256: both sides converge the same share of lanes
    (within 0.05), their χ² floors agree, and on lanes both converged the
    parameters agree to 1e-3 relative on ≥ 90% of lanes for m ≤ 3 (the
    rest are lanes the data do not identify; the 4- and 5-parameter lobes
    are ambiguous at 16 views, so there the bar is χ² alone)."""
    ja, ta, target, p0, _ = _problem(model, seed=2)
    opts = dict(OPTS, itmax=100) if MODELS[model].n_params == 5 else OPTS
    rj, rt = _both(model, ja, ta, target, p0, opts)
    sj, st = np.asarray(rj.stop), rt.stop.numpy()
    conv_j, conv_t = np.isin(sj, CONVERGED), np.isin(st, CONVERGED)
    assert abs(conv_j.mean() - conv_t.mean()) <= 0.05
    assert set(np.unique(st)) <= {1, 2, 3, 5, 6}
    cj, ct = np.asarray(rj.chi2), rt.chi2.numpy()
    assert np.isfinite(ct).all()
    assert np.median(ct) <= max(10 * np.median(cj), 1e-9)
    assert (ct <= np.maximum(10 * cj, 1e-8)).mean() >= 0.97
    both = conv_j & conv_t
    assert both.mean() >= 0.5
    if MODELS[model].n_params <= 3:
        assert _rel_share(rt.p.numpy()[both], np.asarray(rj.p)[both], 1e-3, 1e-3) >= 0.9


@pytest.mark.parametrize("damping", ["add", "marquardt"])
@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance_fresnel", "ward_aniso"])
def test_warm_resume_equals_one_run_bit_for_bit(model, damping):
    """itmax=6, then a resume from the returned (μ, ν, stop) with the lanes
    cut off at MAX_ITERATIONS reopened, equals one run of the full count:
    parameters, χ², stop, μ, ν bit for bit, iterations summed."""
    _, ta, target, p0, _ = _problem(model, seed=3)
    spec = MODELS[model]
    kw = dict(lower=tuple(spec.lower), upper=tuple(spec.upper))
    opts = LMOptions(**dict(OPTS, itmax=30, damping=damping))
    y, p0 = torch.tensor(target), torch.tensor(p0)
    one = k5.lm_fit_fused(model, ta, y, p0, opts=opts, **kw)
    first = k5.lm_fit_fused(model, ta, y, p0, opts=opts._replace(itmax=6), **kw)
    cut = first.stop == int(StopReason.MAX_ITERATIONS)
    assert 0 < int(cut.sum()) < T
    stop = torch.where(cut, torch.zeros_like(first.stop), first.stop)
    second = k5.lm_fit_fused(model, ta, y, first.p, opts=opts._replace(itmax=24),
                             warm=(first.mu, first.nu, stop), **kw)
    for name in ("p", "chi2", "stop", "mu", "nu"):
        torch.testing.assert_close(getattr(second, name), getattr(one, name), rtol=0, atol=0,
                                   msg=name)
    torch.testing.assert_close(torch.where(cut, first.iters + second.iters, first.iters),
                               one.iters, rtol=0, atol=0)
    # a lane that had stopped is returned as it came: no iteration, same stop
    assert float(second.iters[~cut].abs().max()) == 0.0
    torch.testing.assert_close(second.g_inf[cut], one.g_inf[cut], rtol=0, atol=0)


def test_warm_rows_follow_the_kernel_semantics():
    """Non-finite or ≤ 0 μ → Kanzow init; ν < 2 or non-finite → 2; a non-zero
    warm stop short-circuits the lane and is returned unchanged. Same inputs
    through the Pallas kernel give the same lanes (a noisy problem, so that no
    accept decision sits on an ulp of χ²)."""
    model = "blinn_phong"
    ja, ta, target, p0, _ = _problem(model, seed=4, noisy=True)
    mu = np.full(T, 0.5, np.float32)
    mu[::4] = 0.0
    mu[1::4] = np.nan
    mu[2::4] = -1.0
    nu = np.full(T, 8.0, np.float32)
    nu[::3] = 1.0
    nu[1::3] = np.inf
    stop = np.zeros(T, np.float32)
    stop[::5] = 2.0
    stop[1::5] = 4.0
    rj, rt = _both(model, ja, ta, target, p0, dict(OPTS, itmax=1), warm=(mu, nu, stop))
    frozen = stop != 0
    np.testing.assert_array_equal(rt.stop.numpy()[frozen], stop[frozen].astype(np.int32))
    np.testing.assert_array_equal(rt.iters.numpy()[frozen], 0.0)
    np.testing.assert_array_equal(rt.p.numpy()[frozen], p0[frozen])
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.stop.numpy()[frozen], np.asarray(rj.stop)[frozen])
    assert _rel_share(rt.mu.numpy(), rj.mu, 1e-5, 1e-30) >= 0.99
    assert (rt.nu.numpy() == np.asarray(rj.nu)).mean() >= 0.99
    # a cold lane's μ comes from τ·max diag(JᵀJ): it differs from a carried 0.5
    cold = (~frozen) & ~((mu > 0) & np.isfinite(mu))
    assert cold.any() and (rt.mu.numpy()[cold] != 0.5 / 3).all()


def test_frozen_bound_lanes_match_the_pallas_kernel():
    """Truth outside the box: kd above its upper bound and the exponent above
    its own, so the solve runs along active bounds (the freeze of
    bound-stuck coordinates and the projected step)."""
    model = "blinn_phong"
    ja, ta, target, p0, true_p = _problem(model, seed=5)
    lower, upper = (0.0, 0.0, 0.0), (0.5, 100.0, 12.0)
    p0 = np.clip(p0, lower, upper).astype(np.float32)
    rj, rt = _both(model, ja, ta, target, p0, OPTS, lower=lower, upper=upper)
    pt, pj = rt.p.numpy(), np.asarray(rj.p)
    assert (pt >= np.asarray(lower) - 0).all() and (pt <= np.asarray(upper)).all()
    at_bound = (true_p[:, 0] > 0.5) | (true_p[:, 2] > 12.0)
    assert at_bound.mean() > 0.5
    on_t = (pt[:, 0] == 0.5) | (pt[:, 2] == 12.0)
    on_j = (pj[:, 0] == 0.5) | (pj[:, 2] == 12.0)
    assert (on_t == on_j).mean() >= 0.97 and on_t[at_bound].mean() >= 0.9
    cj, ct = np.asarray(rj.chi2), rt.chi2.numpy()
    assert _rel_share(ct, cj, 1e-3, 1e-8) >= 0.95
    assert _rel_share(pt, pj, 1e-3, 1e-3) >= 0.9


@pytest.mark.parametrize("damping", ["add", "marquardt"])
def test_both_damping_modes_match_the_pallas_kernel(damping):
    model = "blinn_phong"
    ja, ta, target, p0, _ = _problem(model, seed=9)
    opts = dict(eps1=1e-9, eps2=1e-9, eps3=1e-14, itmax=40, tau=1e-10, damping=damping)
    jn, tn, target_n, p0_n, _ = _problem(model, seed=9, noisy=True)
    rj1, rt1 = _both(model, jn, tn, target_n, p0_n, dict(opts, itmax=1))
    # τ = 1e-10 leaves the first solve all but undamped, so it amplifies the
    # one-ulp differences of JᵀJ: measured over two seeds and both modes,
    # ≥ 0.988 of lanes within 1e-4 (0.93–0.96 within 1e-5)
    assert _rel_share(rt1.p.numpy(), rj1.p, 1e-4, 1e-3) >= 0.98
    assert _rel_share(rt1.mu.numpy(), rj1.mu, 1e-4, 1e-30) >= 0.98
    rj, rt = _both(model, ja, ta, target, p0, opts)
    ct = rt.chi2.numpy()
    assert np.isfinite(ct).all() and np.median(ct) < 1e-9
    assert abs(np.isin(rt.stop.numpy(), CONVERGED).mean()
               - np.isin(np.asarray(rj.stop), CONVERGED).mean()) <= 0.05
    # zero-information columns must not be flagged singular under the diag floor
    assert (rt.stop.numpy() == 4).mean() < 0.01


@pytest.mark.parametrize("select_chi2", [None, 1e-9])
def test_compacted_fit_matches_pallas_compacted(select_chi2):
    """Two fused fits around gathers and scatters; a slab smaller than the
    tail (overflow keeps its phase-1 result) and fill slots past the tail."""
    model = "cook_torrance_fresnel"
    ja, ta, target, p0, _ = _problem(model, seed=6)
    spec = MODELS[model]
    kw = dict(lower=tuple(spec.lower), upper=tuple(spec.upper), block_t=32, first_itmax=3,
              tail_frac=8, select_chi2=select_chi2)
    opts = dict(OPTS, itmax=30)
    rj = lm_fit_pallas_compacted(model, ja, jnp.asarray(target), jnp.asarray(p0),
                                 opts=JOptions(**opts), interpret=True, **kw)
    rt = k5.lm_fit_compacted(model, ta, torch.tensor(target), torch.tensor(p0),
                             opts=LMOptions(**opts), **kw)
    first = k5.lm_fit_fused(model, ta, torch.tensor(target), torch.tensor(p0),
                            opts=LMOptions(**dict(opts, itmax=3)), lower=kw["lower"],
                            upper=kw["upper"])
    tail = (first.chi2 > 1e-9) if select_chi2 else (first.stop == 3)
    assert int(tail.sum()) > 32          # the slab (32 lanes) overflows
    beyond = torch.nonzero(tail)[32:, 0]
    for name in ("p", "chi2", "stop", "iters"):
        torch.testing.assert_close(getattr(rt, name)[beyond], getattr(first, name)[beyond],
                                   rtol=0, atol=0)
    untouched = ~tail
    torch.testing.assert_close(rt.p[untouched], first.p[untouched], rtol=0, atol=0)
    it_t, it_j = rt.iters.numpy(), np.asarray(rj.iters)
    assert (it_t > 3).sum() > 0 and abs(float(it_t.mean()) - float(it_j.mean())) <= 1.0
    assert (np.isin(rt.stop.numpy(), CONVERGED) == np.isin(np.asarray(rj.stop), CONVERGED)
            ).mean() >= 0.9
    assert np.median(rt.chi2.numpy()) <= max(10 * np.median(np.asarray(rj.chi2)), 1e-9)


def test_compacted_fit_with_a_tail_smaller_than_the_slab():
    model = "blinn_phong"
    _, ta, target, p0, _ = _problem(model, seed=7)
    spec = MODELS[model]
    kw = dict(lower=tuple(spec.lower), upper=tuple(spec.upper))
    y, p0 = torch.tensor(target), torch.tensor(p0)
    opts = LMOptions(**dict(OPTS, itmax=30))
    rc = k5.lm_fit_compacted(model, ta, y, p0, opts=opts, block_t=256, first_itmax=6, **kw)
    first = k5.lm_fit_fused(model, ta, y, p0, opts=opts._replace(itmax=6), **kw)
    cut = first.stop == 3
    assert 0 < int(cut.sum()) < 256
    stop = torch.where(cut, torch.zeros_like(first.stop), first.stop)
    second = k5.lm_fit_fused(model, ta, y, first.p, opts=opts,
                             warm=(first.mu, first.nu, stop), **kw)
    torch.testing.assert_close(rc.p, second.p, rtol=0, atol=0)
    torch.testing.assert_close(rc.stop, second.stop, rtol=0, atol=0)
    torch.testing.assert_close(rc.iters, first.iters + second.iters, rtol=0, atol=0)


def test_wrapper_checks_bounds_views_and_device():
    _, ta, target, p0, _ = _problem("lambert", seed=8, t=16)
    with pytest.raises(ValueError, match="params"):
        k5.lm_fit_fused("lambert", ta, torch.tensor(target), torch.tensor(p0),
                        lower=(0.0, 0.0, 0.0), upper=(1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="damping"):
        k5.config("lambert", LMOptions(damping="none"), (0.0,), (1.0,))
    lanes, vpl, block_t = k5.lane_layout(9, 16)
    assert vpl == -(-16 // lanes) <= k5.views_per_lane(9) and lanes * block_t == k5.THREADS
    assert k5.lane_layout(9, 64)[0] > lanes       # a texel takes more lanes for more views
    with pytest.raises(ValueError, match="lm_fit_chunked"):     # the chunked tier's view counts
        k5.lane_layout(9, 256)
    cfg = k5.config("lambert", LMOptions(), (0.0,), (1.0,))
    rows = k5.stack_inputs("lambert", ta, torch.tensor(target), torch.tensor(p0))
    with pytest.raises(ValueError, match="CUDA"):
        k5.lm_rows_cuda(cfg, *rows)
    assert k5.LAUNCHES == 0
    assert set(k5.PALLAS_MODELS) == set(ALL_LOBES)


def test_convert_carries_fused_results_and_warm_state():
    model = "ward_aniso"
    ja, ta, target, p0, _ = _problem(model, seed=10, t=32)
    spec = MODELS[model]
    rj = lm_fit_pallas(model, ja, jnp.asarray(target), jnp.asarray(p0),
                       opts=JOptions(**dict(OPTS, itmax=4)), lower=tuple(spec.lower),
                       upper=tuple(spec.upper), block_t=128, interpret=True)
    rt = convert.from_numpy(rj)
    assert isinstance(rt, k5.PallasFitResult) and rt.stop.dtype == torch.int32
    assert ta.cos_bv is not None and ta.cos_bv.shape == (32, V)
    back = convert.to_numpy(rt)
    np.testing.assert_array_equal(back.mu, np.asarray(rj.mu))
    warm = convert.warm_from_numpy((rj.mu, rj.nu, rj.stop))
    assert warm[0].dtype == torch.float32 and warm[2].dtype == torch.int32
    # the same state resumes both sides to the same lanes
    stop = np.where(np.asarray(rj.stop) == 3, 0, np.asarray(rj.stop)).astype(np.float32)
    r2j, r2t = _both(model, ja, ta, target, np.asarray(rj.p), dict(OPTS, itmax=1),
                     warm=(np.asarray(rj.mu), np.asarray(rj.nu), stop))
    np.testing.assert_array_equal(r2t.iters.numpy(), np.asarray(r2j.iters))
    assert _rel_share(r2t.p.numpy(), r2j.p, 1e-4, 1e-3) >= 0.9      # a roughness lobe's bar
    lm = LMResult(*([torch.zeros(3)] * 12))
    assert isinstance(convert.from_numpy(convert.to_numpy(lm)), LMResult)
