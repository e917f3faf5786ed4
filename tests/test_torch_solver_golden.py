"""The port's levmar family (brdf_tpu_torch/solver/{lm,constrained,problems}.py)
against the JAX package's on the golden problems of tests/test_lm_golden.py,
in float64 on the same problems (tests/test_torch_solver_modes.py runs the
solver's options and tests/test_lm_hard.py's cases).

In float64 the two solvers take the same decisions until a last step sits
on an ulp of χ² (an ``exp`` that rounds the other way): so every case holds
χ² to 1e-8 and parameters to 1e-8 (1e-7 where named; relative, with a floor
of 1 on |p| and χ²) and the stop code equal, and the counters (iterations,
evaluations, solves) equal but on the cases named."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.solver import constrained as jc, lm as jl, problems as jp  # noqa: E402
from brdf_tpu_torch.solver import StopReason, constrained as tc, lm as tl, problems as tp  # noqa: E402

COUNTERS = ("iters", "stop", "nfev", "njev", "nlss")
J_BY_NAME = {p.name: p for p in jp.PROBLEMS}
T_BY_NAME = {p.name: p for p in tp.PROBLEMS}
# the cases whose counters differ at the last steps (an ulp of χ² decides a
# SMALL_DP or one more rejected try; measured 19 of 26 equal): parameters to
# 1e-7 there (combustion's differ by 1.2e-8 of |p|)
ULP_DECIDED = {"meyer", "osborne", "combustion", "bt3_lec", "mod1hs52_blec", "modbt7_blec",
               "modhs76_bleic"}
# the same decisions, but a minimum that the last step pins to 3e-8 only
FLAT_MINIMUM = {"hatfldb"}


def _solve(lm, cons, prob, p0, opts):
    """tests/test_lm_golden.py::test_golden_problem's dispatch."""
    boxed = prob.lower is not None or prob.upper is not None
    if prob.C is not None:
        return cons.levmar_bleic(prob.residual, p0, prob.A, prob.b, prob.C, prob.d,
                                 lower=prob.lower, upper=prob.upper, data=prob.data, opts=opts,
                                 data_axes=None)
    if prob.A is not None and boxed:
        kw = {} if prob.penalty_weight is None else dict(penalty_weight=prob.penalty_weight)
        return cons.levmar_blec(prob.residual, p0, prob.A, prob.b, lower=prob.lower,
                                upper=prob.upper, data=prob.data, opts=opts, data_axes=None, **kw)
    if prob.A is not None:
        return lm.levmar_lec(prob.residual, p0, prob.A, prob.b, data=prob.data, opts=opts,
                             data_axes=None)
    if boxed:
        return lm.levmar_bc(prob.residual, p0, prob.lower, prob.upper, data=prob.data,
                            opts=opts, data_axes=None)
    return lm.levmar(prob.residual, p0, data=prob.data, opts=opts, data_axes=None)


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


@pytest.mark.parametrize("name", [p.name for p in jp.PROBLEMS])
def test_golden_problem_matches_jax(name):
    """Every golden problem through the same entry point in both packages:
    the same minimum, stop code and, but for the ulp-decided cases, the same
    counters; the minimum is the known one (test_lm_golden.py's bar)."""
    pj, pt = J_BY_NAME[name], T_BY_NAME[name]
    opts = dict(itmax=max(300, pj.itmax))
    rj = _solve(jl, jc, pj, jnp.asarray(pj.p0, jnp.float64), jl.LMOptions(**opts))
    rt = _solve(tl, tc, pt, torch.tensor(pt.p0, dtype=torch.float64), tl.LMOptions(**opts))
    _close(rt, rj, p_rtol=1e-7 if name in ULP_DECIDED | FLAT_MINIMUM else 1e-8)
    np.testing.assert_allclose(rt.p.numpy(), pt.p_star, atol=pt.tol, rtol=pt.tol)
    assert int(rt.stop) in (StopReason.SMALL_GRADIENT, StopReason.SMALL_DP,
                            StopReason.SMALL_CHI2)
    if name not in ULP_DECIDED:
        assert _counters(rt) == _counters(rj)
    np.testing.assert_allclose(float(rt.constraint_violation), float(rj.constraint_violation),
                               atol=1e-10)


def test_batched_solves_match_individual_and_jax():
    """test_lm_golden.py::test_batched_solves_match_individual: a batch of
    expfit problems, every lane equal to the JAX package's and to its own
    solve alone."""
    t, _ = tp.make_expfit_data()
    rng = np.random.default_rng(0)
    true_params = np.abs(rng.normal(size=(8, 3))) + np.array([1.0, 0.05, 0.5])
    ys = true_params[:, 0:1] * np.exp(-true_params[:, 1:2] * t[None]) + true_params[:, 2:3]
    tt = np.broadcast_to(t, ys.shape)
    p0 = np.broadcast_to(np.array([1.0, 0.0, 0.0]), (8, 3))
    opts = dict(itmax=300)
    rj = jl.levmar(jp._exponential_fit, jnp.asarray(p0), data=(jnp.asarray(tt), jnp.asarray(ys)),
                   opts=jl.LMOptions(**opts))
    rt = tl.levmar(tp._exponential_fit, torch.tensor(p0), data=(torch.tensor(tt), torch.tensor(ys)),
                   opts=tl.LMOptions(**opts))
    _close(rt, rj)
    assert _counters(rt) == _counters(rj)
    np.testing.assert_allclose(rt.p.numpy(), true_params, rtol=1e-4, atol=1e-4)
    single = tl.levmar(tp._exponential_fit, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64),
                       data=(torch.tensor(tt[3]), torch.tensor(ys[3])), opts=tl.LMOptions(**opts),
                       data_axes=None)
    np.testing.assert_allclose(single.p.numpy(), rt.p[3].numpy(), rtol=1e-12)
    assert int(single.iters) == int(rt.iters[3])
