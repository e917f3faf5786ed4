"""The eager LM tier (brdf_tpu_torch/solver/lm.py::levmar_bc) against the JAX
package's ``levmar_bc`` on the same numpy problems, in float64.

In float64 the two state machines take the same decisions, so outcomes and
counters are compared lane for lane: χ² and parameters to 1e-8, stop codes,
iterations and the evaluation counters equal (on the share of lanes stated
in each test, where a decision can sit on an ulp of χ²)."""

from contextlib import nullcontext

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.solver import lm as jlm  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles  # noqa: E402
from brdf_tpu_torch.parallel.mesh import make_mesh, use_mesh  # noqa: E402
from brdf_tpu_torch.solver import lm as tlm  # noqa: E402
from torch_port_inputs import angle_columns, true_params  # noqa: E402

T, V = 64, 16
OPTS = dict(eps1=1e-8, eps2=1e-9, eps3=1e-22, itmax=40)
COUNTERS = ("iters", "stop", "nfev", "njev", "nlss")


def _problem(model, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, T, V, dtype=np.float64, tangent=J_MODELS[model].tangent)
    true_p = true_params(model, rng, T, dtype=np.float64)
    ja = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), ja))
    y = y + noise * rng.normal(size=y.shape)
    w = (rng.uniform(size=y.shape) > 0.1).astype(np.float64)
    spec = MODELS[model]
    p0 = np.clip(true_p * rng.uniform(0.7, 1.3, true_p.shape), spec.lower, spec.upper)
    return cols, y, w, p0, true_p


def _both(model, cols, y, w, p0, opts, warm=None, lower=None, upper=None):
    spec_j, spec_t = J_MODELS[model], MODELS[model]
    lower = spec_t.lower if lower is None else lower
    upper = spec_t.upper if upper is None else upper

    def res_j(p, d):
        ang, yy, ww = d
        return (spec_j.fn(p, ang) - yy) * ww

    def res_t(p, d):
        ang, yy, ww = d
        return (spec_t.fn(p, ang) - yy) * ww

    ja = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    ta = ShadingAngles(**{k: torch.tensor(x) for k, x in cols.items()})
    rj = jlm.levmar_bc(res_j, jnp.asarray(p0), lower, upper,
                       data=(ja, jnp.asarray(y), jnp.asarray(w)), opts=jlm.LMOptions(**opts),
                       warm_state=None if warm is None else tuple(jnp.asarray(x) for x in warm))
    rt = tlm.levmar_bc(res_t, torch.tensor(p0), lower, upper,
                       data=(ta, torch.tensor(y), torch.tensor(w)), opts=tlm.LMOptions(**opts),
                       warm_state=None if warm is None else convert.warm_from_numpy(warm))
    return rj, rt


def _same(rt, rj, fields=COUNTERS):
    """Share of lanes on which every listed integer field is equal."""
    eq = np.ones(np.asarray(rj.stop).shape, bool)
    for f in fields:
        eq &= getattr(rt, f).numpy() == np.asarray(getattr(rj, f))
    return float(eq.mean())


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "oren_nayar",
                                   "cook_torrance_fresnel", "ward_aniso"])
def test_levmar_bc_matches_jax_in_float64(model):
    """Noisy targets (χ² well above the float64 floor): the same stop codes
    and counters on ≥ 90% of lanes (measured 0.94–1.0 over the five lobes;
    the rest take one more or one fewer rejected try at the end), and on
    those lanes χ² to 1e-8 and parameters to 1e-6."""
    cols, y, w, p0, _ = _problem(model, seed=3, noise=0.01)
    rj, rt = _both(model, cols, y, w, p0, OPTS)
    assert rt.p.dtype == torch.float64 and rt.stop.dtype == torch.int32
    assert _same(rt, rj) >= 0.9
    same = np.all([getattr(rt, f).numpy() == np.asarray(getattr(rj, f)) for f in COUNTERS], 0)
    np.testing.assert_allclose(rt.chi2.numpy()[same], np.asarray(rj.chi2)[same], rtol=1e-8)
    np.testing.assert_allclose(rt.p.numpy()[same], np.asarray(rj.p)[same], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rt.chi2_init.numpy(), np.asarray(rj.chi2_init), rtol=1e-12)
    # every lane, same decisions or not, reaches the same floor
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2), rtol=1e-6)
    assert float(rt.constraint_violation.abs().max()) == 0.0
    assert (rt.nfev.numpy() == 1 + rt.nlss.numpy()).all()
    assert (rt.njev.numpy() == rt.iters.numpy()).all()


def test_first_iterations_are_equal_lane_for_lane():
    """Three outer iterations from the same start: every counter, μ, ν and
    the projected-gradient norm agree on every lane."""
    cols, y, w, p0, _ = _problem("blinn_phong", seed=4, noise=0.01)
    rj, rt = _both("blinn_phong", cols, y, w, p0, dict(OPTS, itmax=3))
    assert _same(rt, rj) == 1.0
    assert set(np.unique(rt.stop.numpy())) <= {1, 2, 3, 6}
    for f in ("p", "chi2", "mu", "g_inf"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=1e-8, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(rt.nu.numpy(), np.asarray(rj.nu))


def test_exact_targets_converge_like_jax():
    """Exact targets: χ² falls to the float64 floor, where accept decisions
    sit on an ulp, so lanes are compared by outcome."""
    cols, y, w, p0, true_p = _problem("cook_torrance", seed=5)
    rj, rt = _both("cook_torrance", cols, y, w, p0, dict(OPTS, itmax=80))
    conv_t = np.isin(rt.stop.numpy(), (1, 2, 6))
    conv_j = np.isin(np.asarray(rj.stop), (1, 2, 6))
    assert (conv_t == conv_j).mean() >= 0.95
    both = conv_t & conv_j & (np.asarray(rj.chi2) < 1e-18)
    assert both.mean() > 0.5
    np.testing.assert_allclose(rt.p.numpy()[both], np.asarray(rj.p)[both], rtol=1e-6, atol=1e-8)
    assert np.median(rt.chi2.numpy()) <= max(10 * np.median(np.asarray(rj.chi2)), 1e-24)


def test_warm_state_resumes_a_chunked_solve():
    """itmax=4, then a resume from ``warm_state()``: equal to one run of 12
    within the port, bit for bit, and to the JAX package's resume."""
    model = "ward"
    cols, y, w, p0, _ = _problem(model, seed=6, noise=0.01)
    _, one = _both(model, cols, y, w, p0, dict(OPTS, itmax=12))
    rj1, rt1 = _both(model, cols, y, w, p0, dict(OPTS, itmax=4))
    warm_t = rt1.warm_state()
    assert int((warm_t[2] == 0).sum()) > 0                 # MAX_ITERATIONS lanes reopened
    assert (rt1.stop.numpy() == 3).sum() == (warm_t[2] == 0).sum()
    warm = convert.to_numpy(warm_t)
    for a, b in zip(warm, rj1.warm_state()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)     # μ magnifies ρ's last digits
    rj2, rt2 = _both(model, cols, y, w, rt1.p.numpy(), dict(OPTS, itmax=8), warm=warm)
    active = warm[2] == 0
    for f in ("p", "chi2", "mu", "nu", "stop"):
        got = getattr(rt2, f)
        got = torch.where(torch.tensor(active)[:, None] if got.ndim == 2 else torch.tensor(active),
                          got, getattr(rt1, f))
        torch.testing.assert_close(got, getattr(one, f), rtol=0, atol=0, msg=f)
    torch.testing.assert_close(rt1.iters + torch.where(torch.tensor(active), rt2.iters, 0),
                               one.iters, rtol=0, atol=0)
    # lanes that had stopped short-circuit: no iteration, one evaluation
    assert (rt2.iters.numpy()[~active] == 0).all() and (rt2.nfev.numpy()[~active] == 1).all()
    assert _same(rt2, rj2) >= 0.95


def test_warm_state_sanitises_mu_and_nu():
    """μ ≤ 0 or non-finite → Kanzow init; non-finite ν → 2; a final stop is
    returned as it came. Same lanes as the JAX package."""
    model = "blinn_phong"
    cols, y, w, p0, _ = _problem(model, seed=7, noise=0.01)
    mu = np.full(T, 0.5)
    mu[::4], mu[1::4], mu[2::4] = 0.0, np.nan, -1.0
    nu = np.full(T, 8.0)
    nu[1::3] = np.inf
    stop = np.zeros(T, np.int32)
    stop[::5], stop[1::5] = 2, 4
    rj, rt = _both(model, cols, y, w, p0, dict(OPTS, itmax=2), warm=(mu, nu, stop))
    assert _same(rt, rj) == 1.0
    np.testing.assert_array_equal(rt.stop.numpy()[stop != 0], stop[stop != 0])
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=1e-8)
    np.testing.assert_array_equal(rt.nu.numpy(), np.asarray(rj.nu))


def test_active_bounds_freeze_and_project():
    """Truth outside a tightened box: the solve runs along the bounds."""
    model = "blinn_phong"
    cols, y, w, p0, true_p = _problem(model, seed=8, noise=0.01)
    lower, upper = (0.0, 0.0, 0.0), (0.5, 100.0, 12.0)
    p0 = np.clip(p0, lower, upper)
    rj, rt = _both(model, cols, y, w, p0, OPTS, lower=lower, upper=upper)
    pt = rt.p.numpy()
    assert (pt >= np.asarray(lower)).all() and (pt <= np.asarray(upper)).all()
    assert ((pt[:, 0] == 0.5) | (pt[:, 2] == 12.0)).mean() > 0.5
    assert _same(rt, rj, ("stop",)) >= 0.95
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2), rtol=1e-6)
    np.testing.assert_allclose(pt, np.asarray(rj.p), rtol=1e-5, atol=1e-7)


def test_single_problem_analytic_jacobian_and_shared_data():
    """An unbatched (m,) problem with an analytic ``jac_fn`` and shared data
    (``data_axes=None``): an exponential decay fit."""
    rng = np.random.default_rng(9)
    x = np.linspace(0.0, 4.0, 40)
    y = 2.5 * np.exp(-1.3 * x) + 0.2 + 0.01 * rng.normal(size=x.shape)
    p0 = np.array([1.0, 0.5, 0.0])

    def make(xp, exp, stack):
        def res(p, d):
            return p[0] * exp(-p[1] * d[0]) + p[2] - d[1]

        def jac(p, d):
            e = exp(-p[1] * d[0])
            return stack([e, -p[0] * d[0] * e, xp.ones_like(e)], -1)
        return res, jac

    res_j, jac_j = make(jnp, jnp.exp, jnp.stack)
    res_t, jac_t = make(torch, torch.exp, torch.stack)
    opts = dict(OPTS, itmax=50)
    rj = jlm.levmar_bc(res_j, jnp.asarray(p0), 0.0, 10.0, data=(jnp.asarray(x), jnp.asarray(y)),
                       opts=jlm.LMOptions(**opts), jac_fn=jac_j)
    rt = tlm.levmar_bc(res_t, torch.tensor(p0), 0.0, 10.0, data=(torch.tensor(x), torch.tensor(y)),
                       opts=tlm.LMOptions(**opts), jac_fn=jac_t)
    assert rt.p.shape == (3,) and rt.chi2.shape == ()
    for f in COUNTERS:
        assert int(getattr(rt, f)) == int(getattr(rj, f)), f
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=1e-8)
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-8)
    # autodiff Jacobian and a batch sharing its data give the same answer
    pb = np.stack([p0, p0 * 1.1])
    rb = tlm.levmar_bc(res_t, torch.tensor(pb), 0.0, 10.0,
                       data=(torch.tensor(x), torch.tensor(y)), opts=tlm.LMOptions(**opts),
                       data_axes=None)
    np.testing.assert_allclose(rb.p[0].numpy(), rt.p.numpy(), rtol=1e-8)
    assert int(rb.iters[0]) == int(rt.iters)


def test_runs_in_the_dtype_of_p0():
    cols, y, w, p0, _ = _problem("lambert", seed=10, noise=0.01)
    f32 = {k: x.astype(np.float32) for k, x in cols.items()}
    ta = ShadingAngles(**{k: torch.tensor(x) for k, x in f32.items()})
    spec = MODELS["lambert"]
    r = tlm.levmar_bc(lambda p, d: (spec.fn(p, d[0]) - d[1]) * d[2], torch.tensor(p0, dtype=torch.float32),
                      spec.lower, spec.upper,
                      data=(ta, torch.tensor(y, dtype=torch.float32), torch.tensor(w, dtype=torch.float32)),
                      opts=tlm.LMOptions(**dict(OPTS, eps1=1e-6, eps2=1e-7, eps3=1e-12)))
    assert r.p.dtype == torch.float32 and r.chi2.dtype == torch.float32
    assert np.isin(r.stop.numpy(), (1, 2, 6)).all()


@pytest.mark.parametrize("kwargs, opts", [
    (dict(dscl=[1.0, 1.0, 1.0]), {}),
    (dict(jac_mode="fd"), {}),
    (dict(jac_mode="fd_central"), {}),
    (dict(jac_mode="secant"), {}),
    ({}, dict(linsolver="qr")),
    ({}, dict(linsolver="svd")),
    ({}, dict(axis_name="view")),
])
def test_unported_modes_name_their_roadmap_item(kwargs, opts):
    """The modes that once raised run now (ROADMAP.md Queue A items 9 and 5
    are done) and give the JAX package's result on a small problem. An
    ``axis_name`` needs a current mesh, as an axis name needs a bound axis
    in JAX; over the 1 × 1 mesh its sums are the identity
    (tests/test_torch_sharding.py runs real ones)."""
    def res_t(p, d):
        return torch.stack([p[0] - d[0], 10.0 * (p[1] - p[0] ** 2), p[2] * p[1] - d[1]])

    def res_j(p, d):
        return jnp.stack([p[0] - d[0], 10.0 * (p[1] - p[0] ** 2), p[2] * p[1] - d[1]])

    p0, data = np.array([[0.5, 0.1, 1.0], [2.0, 1.0, -1.0]]), np.array([[1.5, 2.0], [0.5, -1.0]])
    mesh = nullcontext()
    if "axis_name" in opts:
        with pytest.raises(ValueError, match="use_mesh"):
            tlm.levmar_bc(res_t, torch.tensor(p0), data=torch.tensor(data),
                          opts=tlm.LMOptions(**opts), **kwargs)
        mesh = use_mesh(make_mesh(device="cpu"))
    with mesh:
        rt = tlm.levmar_bc(res_t, torch.tensor(p0), data=torch.tensor(data),
                           opts=tlm.LMOptions(**dict(OPTS, **opts)), **kwargs)
    opts = {k: v for k, v in opts.items() if k != "axis_name"}
    rj = jlm.levmar_bc(res_j, jnp.asarray(p0), data=jnp.asarray(data),
                       opts=jlm.LMOptions(**dict(OPTS, **opts)), **kwargs)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2), rtol=1e-8, atol=1e-20)
    assert _same(rt, rj) == 1.0


def test_unported_entry_points_and_bad_arguments():
    """``levmar``, ``levmar_lec``, ``fd_jacobian`` and ``check_jacobian`` run
    now (tests/test_torch_solver_golden.py holds them against the JAX
    package); unknown options still raise."""
    def res(p, d=None):
        return torch.stack([p[0] - 1.0, p[1] + p[2] - 2.0, p[2]])

    p0 = torch.zeros(3, dtype=torch.float64)
    assert float(tlm.levmar(res, p0, data_axes=None).chi2) < 1e-20
    lec = tlm.levmar_lec(res, p0, np.array([[0.0, 1.0, 1.0]]), np.array([1.0]), data_axes=None)
    assert abs(float(lec.p[1] + lec.p[2]) - 1.0) < 1e-12
    assert tlm.fd_jacobian(res, p0).shape == (3, 3)
    assert float(tlm.check_jacobian(res, p0)) < 1e-8
    with pytest.raises(ValueError, match="jac_mode"):
        tlm.levmar_bc(lambda p, d: p - d, torch.zeros(3), data=torch.ones(3), jac_mode="exact")
    with pytest.raises(ValueError, match="marquardt"):
        tlm.levmar_bc(lambda p, d: p - d, torch.zeros(3), data=torch.ones(3),
                      opts=tlm.LMOptions(damping="marquardt"))
    with pytest.raises(ValueError, match="linsolver"):
        tlm.levmar_bc(lambda p, d: p - d, torch.zeros(3), data=torch.ones(3),
                      opts=tlm.LMOptions(linsolver="cg"))
    with pytest.raises(ValueError, match="data_axes"):
        tlm.levmar_bc(lambda p, d: p - d[0], torch.zeros(3), data=(torch.ones(3),),
                      data_axes=(0, None))
