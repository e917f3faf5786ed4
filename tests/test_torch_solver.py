"""The port's solver pieces against the JAX package in float64: the
closed-form linear solves, the shape grid and grid init, the unfused
VarPro tier, the robust IRLS weights and the LM result type."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.solver import init as jinit, robust as jrobust, varpro as jvarpro  # noqa: E402
from brdf_tpu.solver.lm import LMResult as JResult  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.ops import grid_init  # noqa: E402
from brdf_tpu_torch.solver import init as tinit, robust as trobust, varpro as tvarpro  # noqa: E402
from brdf_tpu_torch.solver.lm import LMResult, StopReason  # noqa: E402
from torch_port_inputs import ALL_LOBES, SEPARABLE, agreement, angle_columns, true_params  # noqa: E402


def _problem(model, t=256, v=16, seed=0):
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v, np.float64)
    p = true_params(model, rng, t, np.float64)
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(p), JAngles(**cols)))
    return cols, p, y


def _chi2(model, cols, y, w, p):
    """Weighted χ² of parameters ``p`` under the JAX lobe, float64."""
    pred = np.asarray(J_MODELS[model].fn(jnp.asarray(p), JAngles(**cols)))
    return np.sum((w * (pred - y)) ** 2, -1)


def test_bvls2_and_nnls2_match_jax():
    """Random Gram entries, boxes that bind on every side."""
    rng = np.random.default_rng(1)
    n = 4096
    a = rng.normal(size=(n, 6, 2))
    y = rng.normal(size=(n, 6))
    aa, ab, bb = (a[..., 0] ** 2).sum(-1), (a[..., 0] * a[..., 1]).sum(-1), (a[..., 1] ** 2).sum(-1)
    ay, by = (a[..., 0] * y).sum(-1), (a[..., 1] * y).sum(-1)
    box = (-0.3, 0.4, 0.0, 0.25)
    jk = jvarpro._bvls2(*(jnp.asarray(x) for x in (aa, ab, bb, ay, by)), *box)
    tk = tvarpro._bvls2(*(torch.tensor(x) for x in (aa, ab, bb, ay, by)), *box)
    for j, t in zip(jk, tk):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-14)
    assert (tk[0].numpy() >= box[0]).all() and (tk[1].numpy() <= box[3]).all()
    jn = jinit._nnls2(*(jnp.asarray(x) for x in (aa, ab, bb, ay, by)))
    tn = grid_init._nnls2(*(torch.tensor(x) for x in (aa, ab, bb, ay, by)))
    for j, t in zip(jn, tn):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("model", ALL_LOBES)
def test_default_shape_grid_matches_jax(model):
    for num in (8, 16):
        np.testing.assert_array_equal(tinit.default_shape_grid(model, num),
                                      jinit.default_shape_grid(model, num))


@pytest.mark.parametrize("refine", [False, True], ids=["grid", "refined"])
@pytest.mark.parametrize("model", SEPARABLE + ("lambert", "oren_nayar", "minnaert"))
def test_linear_grid_init_matches_jax(model, refine):
    cols, _, y = _problem(model, seed=2)
    w = (np.random.default_rng(3).uniform(size=y.shape) > 0.2).astype(np.float64)
    j = np.asarray(jinit.linear_grid_init(model, JAngles(**cols), jnp.asarray(y),
                                          weights=jnp.asarray(w), refine=refine))
    t = tinit.linear_grid_init(model, convert.from_numpy(JAngles(**cols)), torch.tensor(y),
                               weights=torch.tensor(w), refine=refine).numpy()
    assert t.shape == j.shape
    # lanes whose specular basis nearly vanishes on the weighted views leave
    # the shape unidentifiable: their grid costs tie to rounding and either
    # package may pick any point (phong, whose cos_rv is negative on half the
    # views, has the most). Every other lane agrees to float64 rounding, and
    # a lane where the picks differ fits the data equally well — unless a
    # pick's linear pair was clipped to the box after the (unclipped) grid
    # costs had tied.
    assert agreement(t, j, 1e-8) >= 0.9
    c_j, c_t = _chi2(model, cols, y, w, j), _chi2(model, cols, y, w, t)
    scale = np.sum((w * y) ** 2, -1)
    n_lin = J_MODELS[model].linear
    upper = np.asarray(J_MODELS[model].upper[:n_lin])
    clipped = ((j[:, :n_lin] >= upper) | (t[:, :n_lin] >= upper)).any(-1)
    assert clipped.mean() < 0.05
    assert (np.abs(c_t - c_j) <= 1e-9 * scale + 1e-12)[~clipped].all()


@pytest.mark.parametrize("model", SEPARABLE)
def test_varpro_fit_matches_jax(model):
    """The unfused tier, float64, with its own refined init and from a given
    start (the JAX result of the first fit)."""
    cols, true_p, y = _problem(model, seed=4)
    w = np.ones_like(y)
    w[:, 12:] = 0.0
    ja, ta = JAngles(**cols), convert.from_numpy(JAngles(**cols))
    rj = jvarpro.varpro_fit(model, ja, jnp.asarray(y), weights=jnp.asarray(w), iters=8)
    rt = tvarpro.varpro_fit(model, ta, torch.tensor(y), weights=torch.tensor(w), iters=8)
    # init ties (see above) aside, float64 keeps the two on one trajectory;
    # where they part, both reach the same χ² floor
    assert agreement(rt.p.numpy(), np.asarray(rj.p), 1e-6) >= 0.9
    c_t, c_j = rt.chi2.numpy(), np.asarray(rj.chi2)
    same = np.isclose(c_t, c_j, rtol=1e-3, atol=1e-12) | ((c_t < 1e-10) & (c_j < 1e-10))
    assert same.mean() >= 0.97
    np.testing.assert_array_equal(rt.stop.numpy(), np.asarray(rj.stop))
    assert rt.p.dtype == torch.float64 and rt.stop.dtype == torch.int32

    p0 = np.asarray(rj.p) * np.random.default_rng(5).uniform(0.9, 1.1, rj.p.shape)
    rj2 = jvarpro.varpro_fit(model, ja, jnp.asarray(y), p0=jnp.asarray(p0), iters=6)
    rt2 = tvarpro.varpro_fit(model, ta, torch.tensor(y), p0=torch.tensor(p0), iters=6)
    # from one start the lanes part only where the data leave the shape
    # unidentifiable (a flat profiled valley, where accept tests compare χ²
    # values at the float64 floor)
    assert agreement(rt2.p.numpy(), np.asarray(rj2.p), 1e-6) >= 0.95
    c_t, c_j = rt2.chi2.numpy(), np.asarray(rj2.chi2)
    same = np.isclose(c_t, c_j, rtol=1e-4, atol=1e-20) | ((c_t < 1e-10) & (c_j < 1e-10))
    assert same.all()


def test_varpro_fit_rejects_nonseparable():
    cols, _, y = _problem("blinn_phong", t=8)
    with pytest.raises(ValueError, match="separable"):
        tvarpro.varpro_fit("lambert", convert.from_numpy(JAngles(**cols)), torch.tensor(y))


@pytest.mark.parametrize("kind", ["huber", "cauchy", "tukey"])
def test_robust_weights_match_jax(kind):
    rng = np.random.default_rng(6)
    r = rng.normal(scale=0.05, size=(512, 16))
    r[rng.uniform(size=r.shape) < 0.1] *= 40.0          # outliers
    base = (rng.uniform(size=r.shape) > 0.25).astype(np.float64)
    base[:4] = 0.0                                     # no valid view at all
    j = np.asarray(jrobust.robust_weights(jnp.asarray(r), jnp.asarray(base), kind=kind))
    t = trobust.robust_weights(torch.tensor(r), torch.tensor(base), kind=kind).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-15)
    sat = rng.uniform(0.9, 1.0, (64, 16))
    np.testing.assert_array_equal(
        trobust.saturation_weights(torch.tensor(sat)).numpy(),
        np.asarray(jrobust.saturation_weights(jnp.asarray(sat))))
    with pytest.raises(ValueError, match="unknown robust kind"):
        trobust.robust_weights(torch.tensor(r), torch.tensor(base), kind="l1")


def test_warm_state_matches_jax():
    stop = np.array([0, 1, 2, 3, 3, 6, 7], np.int32)
    mu = np.linspace(0.0, 1.0, 7)
    fields = {k: np.zeros(7) for k in JResult._fields}
    fields.update(stop=stop, mu=mu, nu=mu + 2.0)
    j = JResult(**fields).warm_state()
    t = convert.from_numpy(JResult(**fields)).warm_state()
    assert isinstance(convert.from_numpy(JResult(**fields)), LMResult)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(StopReason.MAX_ITERATIONS) == 3
