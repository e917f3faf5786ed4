"""The eager d-D VarPro tiers of ``brdf_tpu_torch/solver/varpro.py``
(``_solve_damped_sym``, ``varpro_fit_nd``, ``varpro_fit_fresnel``, ``_nnls3``,
``varpro_fit_fresnel_lin``) against the JAX package's on the same inputs:
lane for lane in float64, and in float32 by ``tests/test_varpro.py``'s own
bars.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.models.brdf import shading_angles as j_shading_angles  # noqa: E402
from brdf_tpu.solver import varpro as jvp  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.solver import varpro as tvp  # noqa: E402
from torch_port_inputs import (  # noqa: E402
    agreement,
    angle_columns,
    aniso_geometry,
    recovery,
    true_params,
)

T, V = 256, 16
ND_LOBES = ("ward_aniso", "cook_torrance_aniso", "cook_torrance_fresnel")


def _problem(model, seed, t=T, dtype=np.float64):
    rng = np.random.default_rng(seed)
    if J_MODELS[model].tangent:
        pts, nrm, eye, lights = aniso_geometry(rng, t, V)
        ja = j_shading_angles(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(eye),
                              jnp.asarray(lights), tangent_frame=True)
        cols = {k: np.asarray(getattr(ja, k)).astype(dtype) for k in ja._fields
                if getattr(ja, k) is not None}
        true_p = np.stack([rng.uniform(0.1, 0.9, t), rng.uniform(0.3, 1.0, t),
                           rng.uniform(0.15, 0.9, t), rng.uniform(0.15, 0.9, t),
                           rng.uniform(-1.2, 1.2, t)], -1).astype(dtype)
    else:
        cols = angle_columns(rng, t, V, dtype=dtype)
        true_p = true_params(model, rng, t, dtype=dtype)
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), JAngles(**cols))).astype(dtype)
    p0 = (true_p * rng.uniform(0.9, 1.1, true_p.shape)).astype(dtype)
    return cols, true_p, y, p0


def _tensors(*xs):
    return [None if x is None else torch.tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_solve_damped_sym_matches_jax(d):
    """Random symmetric positive definite systems with damping: rtol 1e-12."""
    rng = np.random.default_rng(d)
    n = 512
    a = rng.normal(size=(n, d, d))
    h = np.einsum("nij,nkj->nik", a, a)
    g = rng.normal(size=(n, d))
    lam = 1e-6 * np.trace(h, axis1=1, axis2=2) + 1e-30
    keys = [(j, k) for j in range(d) for k in range(j, d)]
    sj, okj = jvp._solve_damped_sym({k: jnp.asarray(h[:, k[0], k[1]]) for k in keys},
                                    [jnp.asarray(g[:, j]) for j in range(d)], d, jnp.asarray(lam))
    st, okt = tvp._solve_damped_sym({k: torch.tensor(h[:, k[0], k[1]]) for k in keys},
                                    [torch.tensor(g[:, j]) for j in range(d)], d, torch.tensor(lam))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert bool(okt.all())
    for j in range(d):
        np.testing.assert_allclose(st[j].numpy(), np.asarray(sj[j]), rtol=1e-12, atol=0)
    # it solves (H + λI) s = −g
    hd = h + lam[:, None, None] * np.eye(d)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", hd, np.stack([x.numpy() for x in st], -1)),
                               -g, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("model", ND_LOBES)
def test_varpro_fit_nd_matches_jax_in_float64(model):
    """From one start, 6 steps: every parameter within 1e-4 on ≥ 99% of
    lanes, and within 1e-6 on ≥ 99% or, where float64's own one-ulp spread
    is wider (ROADMAP.md Queue C: on ward_aniso a move of the targets by one
    float64 ulp moves up to 3% of the lanes by more than 1e-6 within six
    steps), on as many lanes as that spread less 0.02."""
    cols, _, y, p0 = _problem(model, seed=ND_LOBES.index(model))
    rj = jvp.varpro_fit_nd(model, JAngles(**cols), jnp.asarray(y), p0=jnp.asarray(p0), iters=6)
    ang = convert.from_numpy(JAngles(**cols))
    rt = tvp.varpro_fit_nd(model, ang, *_tensors(y), p0=torch.tensor(p0), iters=6)
    pt, pj = rt.p.numpy(), np.asarray(rj.p)
    assert pt.dtype == np.float64 and pt.shape == pj.shape
    assert agreement(pt, pj, 1e-4) >= 0.99
    bump = np.random.default_rng(99).choice([-1.0, 0.0, 1.0], y.shape)
    y_ulp = np.where(bump == 0, y, np.nextafter(y, np.copysign(np.inf, bump)))
    pu = tvp.varpro_fit_nd(model, ang, torch.tensor(y_ulp), p0=torch.tensor(p0), iters=6).p.numpy()
    assert agreement(pt, pj, 1e-6) >= min(0.99, agreement(pu, pt, 1e-6) - 0.02)
    if model == "cook_torrance_fresnel":
        rf = tvp.varpro_fit_fresnel(ang, *_tensors(y), p0=torch.tensor(p0), iters=6)
        np.testing.assert_array_equal(rf.p.numpy(), pt)


def _gram_systems(rng, n):
    """Gram systems of three random columns and a target: free targets
    (optimum inside or on any face) and targets that are a nonnegative
    combination of one or two columns minus a multiple of another (optimum
    on an edge or a face)."""
    v = 16
    cols = np.abs(rng.normal(size=(n, 3, v)))
    x = rng.uniform(0.0, 1.0, (n, 3))
    kind = rng.integers(0, 4, n)
    x[kind == 1, 2] = -x[kind == 1, 2]                 # a face: x2 pushed below 0
    x[kind == 2, 1:] = -x[kind == 2, 1:]               # an edge: x1, x2 pushed below 0
    y = np.einsum("ni,niv->nv", x, cols)
    y[kind == 3] = rng.normal(size=(int((kind == 3).sum()), v))
    gram = np.einsum("niv,njv->nij", cols, cols)
    r = np.einsum("niv,nv->ni", cols, y)
    args = [gram[:, 0, 0], gram[:, 0, 1], gram[:, 0, 2], gram[:, 1, 1], gram[:, 1, 2],
            gram[:, 2, 2], r[:, 0], r[:, 1], r[:, 2]]
    return args, kind


def test_nnls3_matches_jax():
    """All 8 active sets, the cheapest feasible one, ties as in JAX: rtol
    1e-12 on random Gram systems with optima inside, on faces and on edges."""
    args, kind = _gram_systems(np.random.default_rng(5), 2048)
    xj = jvp._nnls3(*(jnp.asarray(a) for a in args))
    xt = tvp._nnls3(*(torch.tensor(a) for a in args))
    for a, b in zip(xt, xj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)
    x = np.stack([a.numpy() for a in xt], -1)
    assert (x >= 0).all()
    zeros = (x == 0).sum(-1)
    assert (zeros[kind == 1] >= 1).mean() > 0.5 and (zeros[kind == 2] >= 2).mean() > 0.5
    assert (zeros[kind == 0] == 0).mean() > 0.9


def test_varpro_fit_fresnel_lin_matches_jax_in_float64():
    """Grid init and 8 steps, then from a start: within 1e-6 on ≥ 99% of lanes."""
    cols, _, y, p0 = _problem("cook_torrance_fresnel", seed=7, t=512)
    ja, ang = JAngles(**cols), convert.from_numpy(JAngles(**cols))
    for start in (None, p0):
        rj = jvp.varpro_fit_fresnel_lin(ja, jnp.asarray(y), iters=8,
                                        p0=None if start is None else jnp.asarray(start))
        rt = tvp.varpro_fit_fresnel_lin(ang, torch.tensor(y), iters=8,
                                        p0=None if start is None else torch.tensor(start))
        assert rt.p.dtype == torch.float64 and rt.p.shape == (512, 4)
        assert agreement(rt.p.numpy(), np.asarray(rj.p), 1e-6) >= 0.99
        assert float(rt.chi2.median()) < 1e-20 and float(np.median(np.asarray(rj.chi2))) < 1e-20


def test_varpro_fit_fresnel_lin_float32_bars():
    """``tests/test_varpro.py::test_varpro_fresnel_lin_removes_scale_degeneracy``
    on the port: recovery > 0.7 and ≥ the 2-D tier's + 0.05, median χ² <
    1e-12, f0 in [0, 1], masked views inert, a start at the truth honoured."""
    t = 2048
    cols, true_p, y, _ = _problem("cook_torrance_fresnel", seed=0, t=t, dtype=np.float32)
    ang = convert.from_numpy(JAngles(**cols))
    yt = torch.tensor(y)
    r_lin = tvp.varpro_fit_fresnel_lin(ang, yt, iters=10)
    r_2d = tvp.varpro_fit_fresnel(ang, yt, iters=10)
    rec_lin = recovery(r_lin.p.numpy(), true_p)
    assert rec_lin > 0.7
    assert rec_lin >= recovery(r_2d.p.numpy(), true_p) + 0.05
    assert float(r_lin.chi2.median()) < 1e-12
    p = r_lin.p.numpy()
    assert p.dtype == np.float32
    assert p[:, 3].min() >= -1e-6 and p[:, 3].max() <= 1.0 + 1e-6 and p[:, 1].min() >= -1e-6

    w = torch.ones_like(yt)
    w[:, 12:] = 0.0
    bad = yt.clone()
    bad[:, 12:] = 5.0
    r1 = tvp.varpro_fit_fresnel_lin(ang, yt, weights=w, iters=6)
    r2 = tvp.varpro_fit_fresnel_lin(ang, bad, weights=w, iters=6)
    np.testing.assert_array_equal(r1.p.numpy(), r2.p.numpy())

    r_warm = tvp.varpro_fit_fresnel_lin(ang, yt, p0=torch.tensor(true_p), iters=4)
    assert recovery(r_warm.p.numpy(), true_p) >= rec_lin


def test_varpro_fit_nd_float32_masks_views_and_keeps_signed_phi():
    """``tests/test_varpro.py``'s checks of the 3-D tier on the port: poisoned
    views under zero weight change nothing; φ is not floored at 0; χ² reaches
    the floor from the linear grid init."""
    cols, _, y, _ = _problem("ward_aniso", seed=9, dtype=np.float32)
    ang = convert.from_numpy(JAngles(**cols))
    yt = torch.tensor(y)
    w = torch.ones_like(yt)
    w[:, 12:] = 0.0
    bad = yt.clone()
    bad[:, 12:] = 9.0
    r1 = tvp.varpro_fit_nd("ward_aniso", ang, yt, weights=w, iters=6)
    r2 = tvp.varpro_fit_nd("ward_aniso", ang, bad, weights=w, iters=6)
    np.testing.assert_array_equal(r1.p.numpy(), r2.p.numpy())
    r = tvp.varpro_fit_nd("ward_aniso", ang, yt, iters=24)
    p = r.p.numpy()
    assert float(r.chi2.median()) < 1e-10
    assert p[:, 4].min() < -0.1 and p[:, 4].max() > 0.1
    assert p[:, 2].min() >= 1e-3 and p[:, 3].min() >= 1e-3
    with pytest.raises(ValueError, match="varpro_fit_nd supports"):
        tvp.varpro_fit_nd("cook_torrance", ang, yt)
