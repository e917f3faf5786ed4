"""The options of the port's levmar (brdf_tpu_torch/solver/lm.py) against the
JAX package's on the cases of tests/test_lm_golden.py and tests/test_lm_hard.py
that exercise them — the damped-system solvers, the difference and secant
Jacobians, dscl, the Jacobian checks and the hard starts — in float64 on the
same problems (tests/test_torch_solver_golden.py runs the golden problems).

In float64 the two solvers take the same decisions until a last step sits
on an ulp of χ² (an ``exp`` that rounds the other way): parameters and χ²
agree to the tolerance each test states (relative, with a floor of 1 on |p|
and χ²), the stop codes are equal, and the counters (iterations,
evaluations, solves) equal where the test says so."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.solver import lm as jl, problems as jp  # noqa: E402
from brdf_tpu_torch.solver import (  # noqa: E402
    StopReason,
    check_jacobian,
    chkjac,
    lm as tl,
    problems as tp,
)

COUNTERS = ("iters", "stop", "nfev", "njev", "nlss")
J_BY_NAME = {p.name: p for p in jp.PROBLEMS}
T_BY_NAME = {p.name: p for p in tp.PROBLEMS}


def _close(rt, rj, p_rtol=1e-8, chi2_rtol=1e-8, same_stop=True):
    """Parameters and χ² to their tolerances (relative, floor 1 on |p| and
    χ²); the stop codes equal."""
    pj, pt = np.asarray(rj.p), rt.p.numpy()
    np.testing.assert_array_less(np.abs(pt - pj), p_rtol * np.maximum(np.abs(pj), 1.0))
    cj, ct = np.asarray(rj.chi2), rt.chi2.numpy()
    np.testing.assert_array_less(np.abs(ct - cj), chi2_rtol * np.maximum(np.abs(cj), 1.0))
    if same_stop:
        np.testing.assert_array_equal(rt.stop.numpy(), np.asarray(rj.stop))


def _counters(r) -> list:
    return [np.asarray(getattr(r, f)).tolist() for f in COUNTERS]


def test_box_projection_invalid_values_and_analytic_jacobian():
    """test_lm_golden.py's box projection, NaN residual and analytic ``jac_fn``
    cases, each against the JAX package."""
    opts = dict(itmax=300)
    rj = jl.levmar_bc(jp._quad_target, jnp.asarray([5.0, -7.0]), (-1.0, -1.0), (1.0, 1.0),
                      opts=jl.LMOptions(**opts), data_axes=None)
    rt = tl.levmar_bc(tp._quad_target, torch.tensor([5.0, -7.0], dtype=torch.float64),
                      (-1.0, -1.0), (1.0, 1.0), opts=tl.LMOptions(**opts), data_axes=None)
    _close(rt, rj)
    np.testing.assert_allclose(rt.p.numpy(), [1.0, 1.0], atol=1e-8)

    rt = tl.levmar(lambda p, d: torch.stack([torch.sqrt(p[0]), p[1]]),
                   torch.tensor([-1.0, 1.0], dtype=torch.float64), opts=tl.LMOptions(**opts),
                   data_axes=None)
    assert int(rt.stop) == StopReason.INVALID_VALUES and int(rt.iters) == 0

    def res_t(p, d=None):
        return torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    def jac_t(p, d=None):
        return torch.stack([torch.stack([-20.0 * p[0], torch.full_like(p[0], 10.0)]),
                            torch.stack([torch.full_like(p[0], -1.0), torch.zeros_like(p[0])])])

    def res_j(p, d=None):
        return jnp.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    def jac_j(p, d=None):
        return jnp.array([[-20.0 * p[0], 10.0], [-1.0, 0.0]])

    rj = jl.levmar(res_j, jnp.asarray([-1.2, 1.0]), opts=jl.LMOptions(**opts), jac_fn=jac_j,
                   data_axes=None)
    rt = tl.levmar(res_t, torch.tensor([-1.2, 1.0], dtype=torch.float64),
                   opts=tl.LMOptions(**opts), jac_fn=jac_t, data_axes=None)
    _close(rt, rj)
    assert _counters(rt) == _counters(rj)
    np.testing.assert_allclose(rt.p.numpy(), [1.0, 1.0], atol=1e-8)


@pytest.mark.parametrize("linsolver", ["cholesky", "qr", "lu", "svd", "ldlt"])
def test_linsolver_suite_matches_jax(linsolver):
    """test_lm_golden.py::test_linsolver_suite_agrees (and test_axb.py's ldlt
    case): Meyer unconstrained and hatfldb boxed through each damped-system
    solver. hatfldb's counters are equal; Meyer's, ill-conditioned, are
    decided on an ulp."""
    for name in ("meyer", "hatfldb"):
        pj, pt = J_BY_NAME[name], T_BY_NAME[name]
        rj = jl.levmar_bc(pj.residual, jnp.asarray(pj.p0, jnp.float64), pj.lower, pj.upper,
                          data=pj.data, opts=jl.LMOptions(itmax=300, linsolver=linsolver),
                          data_axes=None)
        rt = tl.levmar_bc(pt.residual, torch.tensor(pt.p0, dtype=torch.float64), pt.lower,
                          pt.upper, data=pt.data, opts=tl.LMOptions(itmax=300, linsolver=linsolver),
                          data_axes=None)
        _close(rt, rj, p_rtol=1e-6, chi2_rtol=1e-6)
        np.testing.assert_allclose(rt.p.numpy(), pt.p_star, atol=pt.tol, rtol=pt.tol)
        if name == "hatfldb":
            assert _counters(rt) == _counters(rj)


def test_svd_linsolver_handles_singular_system():
    """test_lm_golden.py: a parameter the residual ignores makes JᵀJ exactly
    singular; the SVD solve converges in the identifiable subspace."""
    def res3(p, data=None):
        return torch.stack([p[0] - 2.0, 3.0 * (p[0] + p[1] - 1.0)])

    r = tl.levmar(res3, torch.tensor([5.0, 5.0, 7.0], dtype=torch.float64),
                  opts=tl.LMOptions(itmax=300, linsolver="svd"), data_axes=None)
    p = r.p.numpy()
    np.testing.assert_allclose(p[:2], [2.0, -1.0], atol=1e-8)
    assert np.isfinite(p).all()


@pytest.mark.parametrize("mode", ["fd", "fd_central", "secant"])
def test_difference_jacobians_match_jax(mode):
    """The forward, central and secant (Broyden) Jacobians on
    test_lm_golden.py::test_secant_jac_mode_converges's problems: the same
    minimum and, on the boxed problems, the same counters — fewer Jacobian
    evaluations than iterations for the secant scheme."""
    for name in ("rosenbrock", "hs01_box", "hatfldb"):
        pj, pt = J_BY_NAME[name], T_BY_NAME[name]
        rj = jl.levmar_bc(pj.residual, jnp.asarray(pj.p0, jnp.float64), pj.lower, pj.upper,
                          data_axes=None, jac_mode=mode, secant_refresh=5,
                          opts=jl.LMOptions(itmax=400))
        rt = tl.levmar_bc(pt.residual, torch.tensor(pt.p0, dtype=torch.float64), pt.lower,
                          pt.upper, data_axes=None, jac_mode=mode, secant_refresh=5,
                          opts=tl.LMOptions(itmax=400))
        _close(rt, rj, p_rtol=1e-6, chi2_rtol=1e-6)
        np.testing.assert_allclose(rt.p.numpy(), pt.p_star, rtol=5e-4, atol=5e-4, err_msg=name)
        if name != "hatfldb" or mode != "secant":
            assert _counters(rt) == _counters(rj), name
        if mode == "secant":
            assert int(rt.njev) < int(rt.iters), name
            assert int(rt.njev) >= 1 + int(rt.iters) // 6, name


def test_secant_batched_matches_unbatched_and_jax():
    def rosen_j(p, _):
        return jnp.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    def rosen_t(p, _):
        return torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    p0 = np.array([[-1.2, 1.0], [2.0, 2.0], [0.5, -0.5]])
    rj = jl.levmar_bc(rosen_j, jnp.asarray(p0), data_axes=None, jac_mode="secant",
                      opts=jl.LMOptions(itmax=300))
    rt = tl.levmar_bc(rosen_t, torch.tensor(p0), data_axes=None, jac_mode="secant",
                      opts=tl.LMOptions(itmax=300))
    _close(rt, rj)
    assert _counters(rt) == _counters(rj)
    for i in range(3):
        one = tl.levmar_bc(rosen_t, torch.tensor(p0[i]), data_axes=None, jac_mode="secant",
                           opts=tl.LMOptions(itmax=300))
        np.testing.assert_allclose(rt.p[i].numpy(), one.p.numpy(), rtol=1e-8, atol=1e-10)


def test_dscl_matches_jax():
    """test_lm_golden.py's two dscl cases: a badly scaled exponential, and
    Rosenbrock with an analytic Jacobian, scaled against unscaled."""
    t = np.linspace(0.0, 1000.0, 32)
    y = 2.0e4 * np.exp(-4.0e-3 * t)
    tj, yj, tt, yt = jnp.asarray(t), jnp.asarray(y), torch.tensor(t), torch.tensor(y)
    kw = dict(lower=(0.0, 0.0), upper=(1e6, 1.0), data_axes=None, dscl=(1.0e4, 1.0e-3))
    rj = jl.levmar_bc(lambda p, d: p[0] * jnp.exp(-p[1] * tj) - yj, jnp.asarray([1.0e4, 1.0e-2]),
                      opts=jl.LMOptions(itmax=200), **kw)
    rt = tl.levmar_bc(lambda p, d: p[0] * torch.exp(-p[1] * tt) - yt,
                      torch.tensor([1.0e4, 1.0e-2], dtype=torch.float64),
                      opts=tl.LMOptions(itmax=200), **kw)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=1e-8)
    np.testing.assert_allclose(rt.p.numpy(), [2.0e4, 4.0e-3], rtol=1e-6)
    assert _counters(rt) == _counters(rj)

    def res(p, d=None):
        return torch.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    def jac(p, d=None):
        return torch.stack([torch.stack([-20.0 * p[0], torch.full_like(p[0], 10.0)]),
                            torch.stack([torch.full_like(p[0], -1.0), torch.zeros_like(p[0])])])

    p0 = torch.tensor([-1.2, 1.0], dtype=torch.float64)
    plain = tl.levmar_bc(res, p0, opts=tl.LMOptions(itmax=300), jac_fn=jac, data_axes=None)
    scaled = tl.levmar_bc(res, p0, opts=tl.LMOptions(itmax=300), jac_fn=jac, data_axes=None,
                          dscl=(2.0, 0.5))
    np.testing.assert_allclose(scaled.p.numpy(), plain.p.numpy(), atol=1e-8)


def test_jacobian_checks_match_jax():
    """check_jacobian (test_lm_golden.py's bar) and chkjac's per-residual
    scores: a correct Jacobian scores near 1, a corrupted column near 0, as
    in the JAX package (scores within 0.05: CHKDER differences an ``exp``
    at √ε)."""
    pj, pt = J_BY_NAME["meyer"], T_BY_NAME["meyer"]
    p = np.array([8.85, 4.0, 2.5])
    ej = float(jl.check_jacobian(pj.residual, jnp.asarray(p)))
    et = float(check_jacobian(pt.residual, torch.tensor(p)))
    assert et < 1e-6 and abs(et - ej) <= 1e-9
    good_j, good_t = jl.chkjac(pj.residual, jnp.asarray(p)), chkjac(pt.residual, torch.tensor(p))
    assert good_t.shape == (16,) and float(good_t.min()) > 0.8
    np.testing.assert_allclose(good_t.numpy(), np.asarray(good_j), atol=0.05)

    def bad_jac(q, data=None):
        j = torch.func.jacfwd(lambda r: pt.residual(r, data))(q)
        return j * torch.tensor([1.0, 3.0, 1.0], dtype=j.dtype)

    assert float(chkjac(pt.residual, torch.tensor(p), jac_fn=bad_jac).max()) < 0.5
    assert float(tl.fd_jacobian(pt.residual, torch.tensor(p)).sub(
        torch.func.jacfwd(lambda q: pt.residual(q, None))(torch.tensor(p))).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# tests/test_lm_hard.py: the cases that engage the box solver's freeze
# ---------------------------------------------------------------------------

HARD_OPTS = dict(tau=1e-3, eps1=1e-12, eps2=1e-12, eps3=1e-15, itmax=200)
_MEYER_Y = np.array([34.780, 28.610, 23.650, 19.630, 16.370, 13.720, 11.540, 9.744,
                     8.261, 7.030, 6.005, 5.147, 4.427, 3.820, 3.307, 2.872])
_MEYER_U = 0.45 + 0.05 * np.arange(16.0)


def _rosen(xp, stack):
    return lambda p, _: stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])


def _meyer(xp, exp):
    u, y = xp(_MEYER_U), xp(_MEYER_Y)
    return lambda p, _: p[0] * exp(10.0 * p[1] / (u + p[2]) - 13.0) - y


def _singular(stack):
    return lambda p, _: stack([p[0] + p[1] - 2.0, 1e-4 * (p[0] - p[1])])


HARD = {
    # name: (JAX residual, port residual, p0, lower, upper, opts, dscl, bars)
    "start_far_outside_box": (_rosen(jnp.asarray, jnp.stack), _rosen(torch.tensor, torch.stack),
                              [100.0, -80.0], (-2.0, -2.0), (0.8, 2.0), HARD_OPTS, None),
    "meyer_illscaled": (_meyer(jnp.asarray, jnp.exp), _meyer(torch.tensor, torch.exp),
                        [8.85, 4.0, 25.0], (1e-4,) * 3, (1e3,) * 3, dict(HARD_OPTS, itmax=1000),
                        None),
    "meyer_dscl": (_meyer(jnp.asarray, jnp.exp), _meyer(torch.tensor, torch.exp),
                   [8.85, 4.0, 25.0], (1e-4,) * 3, (1e3,) * 3, dict(HARD_OPTS, itmax=1000),
                   (0.01, 1.0, 10.0)),
    "near_singular_at_active_bound": (_singular(jnp.stack), _singular(torch.stack), [0.0, 0.0],
                                      (0.0, 0.0), (0.7, 2.0), HARD_OPTS, None),
}
HARD_BARS = {
    "start_far_outside_box": ([0.8, 0.64], 0.04 * (1 + 1e-9), 15),
    "meyer_illscaled": ([2.4817783, 6.1813464, 3.5022364], 8.7945855e-5 * 1.001, 200),
    "meyer_dscl": ([2.4817783, 6.1813464, 3.5022364], 8.7945855e-5 * 1.001, 300),
    "near_singular_at_active_bound": ([0.7, 1.3], 3.6e-9 * (1 + 1e-6), 27),
}


@pytest.mark.parametrize("name", list(HARD))
def test_hard_case_matches_jax(name):
    """Each case of test_lm_hard.py in both packages: the same minimum and
    stop code, and that test's bars on χ², the point and the iterations."""
    res_j, res_t, p0, lower, upper, opts, dscl = HARD[name]
    rj = jl.levmar_bc(res_j, jnp.asarray(p0), lower, upper, data_axes=None,
                      opts=jl.LMOptions(**opts), dscl=None if dscl is None else jnp.asarray(dscl))
    rt = tl.levmar_bc(res_t, torch.tensor(p0, dtype=torch.float64), lower, upper,
                      data_axes=None, opts=tl.LMOptions(**opts), dscl=dscl)
    meyer = name.startswith("meyer")
    # Meyer's scaled problem is ill-conditioned: its last step, and so its
    # stop code (SMALL_GRADIENT or SMALL_DP), is decided on an ulp
    _close(rt, rj, p_rtol=1e-6, chi2_rtol=1e-6, same_stop=not meyer)
    assert int(rt.stop) in (StopReason.SMALL_GRADIENT, StopReason.SMALL_DP)
    p_star, chi2_max, iters_max = HARD_BARS[name]
    assert float(rt.chi2) <= chi2_max
    np.testing.assert_allclose(rt.p.numpy(), p_star, rtol=1e-4, atol=1e-6)
    assert int(rt.iters) <= iters_max
    if not meyer:
        assert _counters(rt) == _counters(rj)


def test_hard_cases_batched_f32():
    """test_lm_hard.py::test_hard_cases_batched_f32 in the port: vmapped
    float32 from hard starts, every lane terminating at the bound-constrained
    minimum."""
    p0 = torch.tensor([[100.0, -80.0], [0.0, 0.0], [-2.0, 1.9], [0.79, -1.99]])
    opts = tl.LMOptions(tau=1e-3, eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=100)
    res = tl.levmar_bc(_rosen(torch.tensor, torch.stack), p0, (-2.0, -2.0), (0.8, 2.0),
                       data_axes=None, opts=opts)
    assert res.p.dtype == torch.float32
    assert int(res.stop.min()) >= 1 and bool(torch.isfinite(res.p).all())
    np.testing.assert_allclose(res.p.numpy(), np.tile([0.8, 0.64], (4, 1)), atol=1e-3)
