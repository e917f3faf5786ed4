"""The rest of the port's solver library against the JAX package on the same
NumPy inputs: the Ax=b suite (brdf_tpu_torch/solver/axb.py, the cases of
tests/test_axb.py), the constrained variants and the fit statistics
(solver/{constrained,stats}.py, tests/test_constrained_stats.py), and the
pipeline's ``FitReport.statistics`` and ``fit_single_material``.

float64 where the JAX function takes float64 (solutions to 1e-10, the
constrained minima to 1e-8); the pipeline's two functions run in float32 in
both packages and are held by the tolerances their tests state."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.pipeline import fit as j_fit  # noqa: E402
from brdf_tpu.solver import axb as ja, constrained as jc, lm as jl, stats as js  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.pipeline import fit as t_fit  # noqa: E402
from brdf_tpu_torch.solver import axb as ta, constrained as tc, lm as tl, stats as ts  # noqa: E402
from torch_port_inputs import angle_columns  # noqa: E402

SOLVERS = ("qr", "chol", "lu", "svd", "ldlt")


def _spd(rng, n):
    m = rng.normal(size=(n, n))
    return m @ m.T + n * np.eye(n)


def _sym_indefinite(rng, n):
    """tests/test_axb.py's strongly indefinite symmetric matrix."""
    m = rng.normal(size=(n, n))
    a = (m + m.T) / 2
    w, v = np.linalg.eigh(a)
    w = w - np.median(w)
    w[np.abs(w) < 0.3] = 0.3 * np.sign(w[np.abs(w) < 0.3] + 1e-30)
    return (v * w) @ v.T


def _both(name, a, b):
    xj = getattr(ja, f"ax_eq_b_{name}")(jnp.asarray(a), jnp.asarray(b))
    xt = getattr(ta, f"ax_eq_b_{name}")(torch.tensor(a), torch.tensor(b))
    return np.asarray(xj), xt.numpy()


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_solvers_match_jax_spd(name, n):
    rng = np.random.default_rng(n)
    a, b = _spd(rng, n), rng.normal(size=(n,))
    xj, xt = _both(name, a, b)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(xt, np.linalg.solve(a, b), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["qr", "lu", "svd", "ldlt"])
@pytest.mark.parametrize("n", [2, 3, 5, 8, 12])
def test_solvers_match_jax_indefinite(name, n):
    """Cholesky legitimately fails on indefinite A; the general solvers and
    the Bunch-Kaufman LDLᵀ must not."""
    rng = np.random.default_rng(100 + n)
    a = _sym_indefinite(rng, n)
    assert np.linalg.eigvalsh(a).min() < 0
    b = rng.normal(size=(n,))
    xj, xt = _both(name, a, b)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(xt, np.linalg.solve(a, b), rtol=1e-8, atol=1e-8)


def test_qrls_and_batches_match_jax():
    """The tall least-squares solve, and every solver on a batch of systems
    against the JAX function under ``vmap``."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(12, 4)), rng.normal(size=(12,))
    xj, xt = _both("qrls", a, b)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(xt, np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-9, atol=1e-9)
    mats = np.stack([_spd(rng, 5) for _ in range(32)])
    bs = rng.normal(size=(32, 5))
    for name in SOLVERS:
        xj = jax.vmap(getattr(ja, f"ax_eq_b_{name}"))(jnp.asarray(mats), jnp.asarray(bs))
        xt = getattr(ta, f"ax_eq_b_{name}")(torch.tensor(mats), torch.tensor(bs))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_ldlt_factorization_equals_jax():
    """The Bunch-Kaufman factors (L, D's diagonal and subdiagonal, the 2×2
    starts, the permutation) equal the JAX package's, one matrix at a time
    and as a batch, and reconstruct A[perm][:, perm] with unit-lower L."""
    rng = np.random.default_rng(7)
    mats = [_sym_indefinite(rng, n) for n in (2, 3, 4, 6, 9)]
    for a in mats:
        fj = [np.asarray(x) for x in ja.ldlt_bk(jnp.asarray(a))]
        ft = [x.numpy() for x in ta.ldlt_bk(torch.tensor(a))]
        for got, ref in zip(ft, fj):
            np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                                       rtol=1e-12, atol=1e-12)
        lmat, d0, d1, b2, perm = ft
        d = np.diag(d0)
        for k in np.nonzero(b2)[0]:
            d[k + 1, k] = d[k, k + 1] = d1[k]
        np.testing.assert_allclose(lmat @ d @ lmat.T, a[perm][:, perm], rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(np.triu(lmat, 1), 0, atol=0)
    batch = np.stack([_sym_indefinite(rng, 5) for _ in range(16)])
    fj = jax.vmap(ja.ldlt_bk)(jnp.asarray(batch))
    ft = ta.ldlt_bk(torch.tensor(batch))
    for got, ref in zip(ft, fj):
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   np.asarray(ref).astype(np.float64), rtol=1e-12, atol=1e-12)


def test_ldlt_pivots_float32_and_singular_like_jax():
    """tests/test_axb.py's stability, float32 and singular cases: a 2×2 pivot
    where unpivoted elimination explodes, float32 accuracy, and a singular
    system that comes back non-finite."""
    a64 = np.array([[1e-7, 1.0], [1.0, 1e-7]])
    b64 = np.array([1.0, 2.0])
    x32 = ta.ax_eq_b_ldlt(torch.tensor(a64, dtype=torch.float32),
                          torch.tensor(b64, dtype=torch.float32))
    np.testing.assert_allclose(x32.numpy(), np.linalg.solve(a64, b64), rtol=1e-5)
    assert bool(ta.ldlt_bk(torch.tensor(a64))[3][0])
    rng = np.random.default_rng(11)
    a = _sym_indefinite(rng, 6)
    b = rng.normal(size=(6,))
    xj = ja.ax_eq_b_ldlt(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    xt = ta.ax_eq_b_ldlt(torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32))
    np.testing.assert_allclose(xt.numpy(), np.linalg.solve(a, b), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)
    zero = ta.ax_eq_b_ldlt(torch.zeros(3, 3, dtype=torch.float64), torch.ones(3, dtype=torch.float64))
    assert not bool(torch.isfinite(zero).all())


def _quad(xp, target):
    def residual(p, data=None):
        return p - xp(target)
    return residual


CONSTRAINED = {
    # tests/test_constrained_stats.py's cases: (function, target, p0, kwargs, expected, atol)
    "blec_interior": ("levmar_blec", (1.0, 2.0, 3.0), [2.0, 2.0, 2.0],
                      dict(A=np.array([[1.0, 1.0, 1.0]]), b=np.array([6.0]), lower=(0, 0, 0),
                           upper=(10, 10, 10)), [1, 2, 3], 1e-5),
    "blec_active_box": ("levmar_blec", (5.0, -3.0), [1.0, 1.0],
                        dict(A=np.array([[1.0, 1.0]]), b=np.array([2.0]), lower=(0.0, 0.0),
                             upper=(4.0, 4.0)), [2.0, 0.0], 1e-2),
    "lic": ("levmar_lic", (0.0, 0.0), [3.0, 3.0],
            dict(C=np.array([[1.0, 1.0]]), d=np.array([2.0])), [1.0, 1.0], 1e-2),
    "blic_inactive": ("levmar_blic", (3.0, 4.0), [1.0, 1.0],
                      dict(C=np.array([[1.0, 0.0]]), d=np.array([1.0]), lower=(0.0, 0.0),
                           upper=(10.0, 10.0)), [3.0, 4.0], 1e-3),
    "bleic_mixed": ("levmar_bleic", (1.0, 1.0, 0.0), [0.0, 0.0, 1.0],
                    dict(A=np.array([[1.0, 1.0, 1.0]]), b=np.array([1.0]),
                         C=np.array([[0.0, 0.0, 1.0]]), d=np.array([0.5])),
                    [0.25, 0.25, 0.5], 1e-2),
    "leic": ("levmar_leic", (1.0, 1.0, 0.0), [0.0, 0.0, 1.0],
             dict(A=np.array([[1.0, 1.0, 1.0]]), b=np.array([1.0]),
                  C=np.array([[0.0, 0.0, 1.0]]), d=np.array([0.5])), [0.25, 0.25, 0.5], 1e-2),
}


# the surplus variable's stiff hinge penalty (w = 1e4) puts the last steps of
# these two on an ulp: one iteration more or fewer (measured)
PENALTY_DECIDED = {"lic", "blic_inactive"}


@pytest.mark.parametrize("case", list(CONSTRAINED))
def test_constrained_variant_matches_jax(case):
    """Each constrained solve in both packages: the same point, χ², surfaced
    constraint violation and stop code, and the same counters but for the
    cases named, at the expected minimum."""
    fn, target, p0, kw, expected, atol = CONSTRAINED[case]
    opts = dict(itmax=300)
    rj = getattr(jc, fn)(_quad(jnp.asarray, target), jnp.asarray(p0), opts=jl.LMOptions(**opts),
                         data_axes=None, **kw)
    rt = getattr(tc, fn)(_quad(torch.tensor, target), torch.tensor(p0, dtype=torch.float64),
                         opts=tl.LMOptions(**opts), data_axes=None, **kw)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(float(rt.constraint_violation), float(rj.constraint_violation),
                               rtol=1e-8, atol=1e-12)
    assert int(rt.stop) == int(rj.stop)
    if case not in PENALTY_DECIDED:
        for f in ("iters", "nfev", "njev", "nlss"):
            assert int(getattr(rt, f)) == int(getattr(rj, f)), f
    np.testing.assert_allclose(rt.p.numpy(), expected, atol=atol)


def test_blec_surfaces_constraint_violation_and_batches():
    """The clamped point and the pre-clamp violation (test_constrained_stats.py),
    and a batch of starts solved at once like one at a time."""
    def res_t(p, _):
        return torch.stack([p[0] - 5.0, p[1] - 0.5])

    def res_j(p, _):
        return jnp.stack([p[0] - 5.0, p[1] - 0.5])

    kw = dict(A=np.array([[0.0, 1.0]]), b=np.array([0.5]), lower=(0.0, 0.0), upper=(1.0, 1.0),
              data=None, data_axes=None)
    rt = tc.levmar_blec(res_t, torch.tensor([0.0, 0.5], dtype=torch.float64),
                        opts=tl.LMOptions(itmax=200), **kw)
    rj = jc.levmar_blec(res_j, jnp.asarray([0.0, 0.5]), opts=jl.LMOptions(itmax=200), **kw)
    v = float(rt.constraint_violation)
    assert float(rt.p[0]) <= 1.0 + 1e-6 and 0.0 <= v < 1e-2
    # a difference of two nearly equal numbers: to float64's absolute precision
    np.testing.assert_allclose(v, float(rj.constraint_violation), rtol=0, atol=1e-12)
    starts = torch.tensor([[0.0, 0.5], [0.9, 0.5], [0.2, 0.5]], dtype=torch.float64)
    rb = tc.levmar_blec(res_t, starts, opts=tl.LMOptions(itmax=200), **kw)
    np.testing.assert_allclose(rb.p[0].numpy(), rt.p.numpy(), rtol=1e-12)
    assert rb.constraint_violation.shape == (3,)


def test_fit_statistics_and_r_squared_match_jax():
    """test_constrained_stats.py's linear fit: covariance, stddev,
    correlations and R² equal the JAX package's (1e-9) on the same fit, and
    carry that test's bars."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, 50)
    y = 2.0 * x - 0.5 + rng.normal(0, 0.01, 50)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)

    def res_j(p, data=None):
        return p[0] * xj + p[1] - yj

    def res_t(p, data=None):
        return p[0] * xt + p[1] - yt

    fj = jl.levmar(res_j, jnp.asarray([0.0, 0.0]), data_axes=None, opts=jl.LMOptions(itmax=100))
    ft = tl.levmar(res_t, torch.tensor([0.0, 0.0], dtype=torch.float64), data_axes=None,
                   opts=tl.LMOptions(itmax=100))
    sj = js.fit_statistics(res_j, fj.p, None, yj, data_axes=None)
    st = ts.fit_statistics(res_t, ft.p, None, yt, data_axes=None)
    for key in ("covariance", "stddev", "corcoef", "r2", "chi2"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]), rtol=1e-9, atol=1e-15,
                                   err_msg=key)
    assert float(st["r2"]) > 0.999 and st["corcoef"][0, 1] < -0.5
    sd = st["stddev"].numpy()
    assert 1e-4 < sd[0] < 2e-2 and 1e-4 < sd[1] < 2e-2
    # a batch of fits sharing the data, and R²'s two anchors
    sb = ts.fit_statistics(res_t, torch.stack([ft.p, ft.p * 1.01]), None, yt, data_axes=None)
    np.testing.assert_allclose(sb["stddev"][0].numpy(), sd, rtol=1e-12)
    yy = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(ts.r_squared(yy, yy)) == 1.0
    np.testing.assert_allclose(float(ts.r_squared(torch.full((4,), 2.5), yy)), 0.0)


def _texel_problem(seed, t=64, v=16, noise=0.0):
    """test_constrained_stats.py::test_fit_report_statistics's problem, with
    optional measurement noise."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v)
    ang = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    true_p = np.stack([rng.uniform(.2, .8, (t, 3)), rng.uniform(.3, .9, (t, 3)),
                       rng.uniform(3, 20, (t, 3))], -1).astype(np.float32)
    spec = J_MODELS["blinn_phong"]
    inten = np.stack([np.asarray(spec.fn(jnp.asarray(true_p[:, ch]), ang)) for ch in range(3)], -1)
    inten = (inten + noise * rng.normal(size=inten.shape)).astype(np.float32)
    return j_fit.TexelProblem(angles=ang, intensity=inten, weights=np.ones((t, v), np.float32),
                              face_ids=np.arange(t)), true_p


def test_fit_report_statistics_matches_jax():
    """``FitReport.statistics`` on the same parameters in both packages: on
    noisy targets (σ = 0.01) stddev to 1e-3 and R² to 1e-5 on ≥ 95% of the
    (texel, channel) rows (the port takes χ² and JᵀJ from K6's plain version,
    analytic derivatives summed in K6's order, where the JAX package takes
    ``jacfwd`` in float32), correlations to 1e-3; on exact targets the bars
    of test_constrained_stats.py::test_fit_report_statistics."""
    prob_j, _ = _texel_problem(0, noise=0.01)
    rep_j = j_fit.fit_per_texel(prob_j, "blinn_phong", mask_saturation=False)
    stats_j = rep_j.statistics(prob_j)
    prob_t = convert.from_numpy(prob_j)
    rep_t = t_fit.FitReport(params=torch.tensor(np.asarray(rep_j.params)), face_ids=prob_j.face_ids,
                            result=convert.from_numpy(rep_j.result), model="blinn_phong")
    stats_t = rep_t.statistics(prob_t)
    t = prob_j.intensity.shape[0]
    assert stats_t["stddev"].shape == (t, 3, 3) and stats_t["corcoef"].shape == (t, 3, 3, 3)
    assert stats_t["r2"].shape == (t, 3) and isinstance(stats_t["r2"], np.ndarray)
    sd_ok = np.isclose(stats_t["stddev"], stats_j["stddev"], rtol=1e-3, atol=1e-7).all(-1)
    assert sd_ok.mean() >= 0.95
    # correlations are defined where every stddev is (not a pinned parameter)
    sd_ok &= (stats_j["stddev"] > 1e-6).all(-1)
    assert np.isclose(stats_t["r2"], stats_j["r2"], rtol=0, atol=1e-5).mean() >= 0.95
    np.testing.assert_allclose(stats_t["corcoef"][sd_ok], stats_j["corcoef"][sd_ok], atol=1e-3)

    prob_j, _ = _texel_problem(0)
    rep_t = t_fit.fit_per_texel(convert.from_numpy(prob_j), "blinn_phong", mask_saturation=False,
                                device="cpu")
    stats = rep_t.statistics(convert.from_numpy(prob_j))
    conv = np.isin(rep_t.result.stop.numpy(), (1, 2, 6))
    assert np.median(stats["r2"][conv]) > 0.999
    assert np.median(stats["stddev"][conv]) < 1e-2
    diag = np.diagonal(stats["corcoef"], axis1=-2, axis2=-1)
    defined = stats["stddev"] > 1e-12
    assert np.allclose(diag[conv & defined.all(-1)], 1.0, atol=1e-3)


def test_fit_single_material_matches_jax():
    """One material per channel over every texel's measurements: the JAX
    package's float32 solve and the port's from the same grid-init medians,
    on one shared material plus noise. The starts are equal; the solutions
    agree to 1e-4 and χ² to 1e-4 relative (float32 sums in another order)."""
    rng = np.random.default_rng(3)
    t, v = 96, 16
    cols = angle_columns(rng, t, v)
    ang = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    truth = np.array([[0.5, 0.6, 12.0], [0.3, 0.4, 8.0], [0.7, 0.2, 20.0]], np.float32)
    spec = J_MODELS["blinn_phong"]
    inten = np.stack([np.asarray(spec.fn(jnp.asarray(truth[ch]), ang)) for ch in range(3)], -1)
    inten = (inten + 0.005 * rng.normal(size=inten.shape)).astype(np.float32)
    w = (rng.uniform(size=(t, v)) > 0.1).astype(np.float32)
    prob = j_fit.TexelProblem(angles=ang, intensity=inten, weights=w, face_ids=np.arange(t))
    pj = j_fit.fit_single_material(prob, "blinn_phong")
    pt = t_fit.fit_single_material(convert.from_numpy(prob), "blinn_phong", device="cpu")
    assert pt.shape == (3, 3) and pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), truth, rtol=0.05)
    # the residual both packages minimise, at either solution
    tang = convert.from_numpy(prob).angles

    def chi2(p):
        return [float((((t_fit.MODELS["blinn_phong"].fn(torch.tensor(p[ch]), tang)
                         - torch.tensor(inten[..., ch])) * torch.tensor(w)) ** 2).sum())
                for ch in range(3)]

    np.testing.assert_allclose(chi2(pt.numpy()), chi2(np.asarray(pj)), rtol=1e-4)
