"""The port's lobes (brdf_tpu_torch/models/brdf.py) against the JAX lobes:
values and gradients in float64, the NaN guards at the clamp edges, the
registry, and the angle builders."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.geometry.primitives import icosphere  # noqa: E402
from brdf_tpu.io.rig import led_rig_positions  # noqa: E402
from brdf_tpu.models import brdf as jb  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models import brdf as tb  # noqa: E402
from torch_port_inputs import ALL_LOBES, TANGENT, angle_columns, true_params  # noqa: E402

# float64 on both sides: the two evaluate the same expressions, so values and
# gradients agree to a few ulps of float64 (1e-10 leaves room for exp/log/pow
# differing in the last bits between XLA and torch)
RTOL = 1e-10
ATOL = 1e-12


def _value_and_grads(model, p, cols, ct):
    """Lobe value plus the VJP with cotangent ``ct`` w.r.t. params and every
    angle channel, in both packages."""
    names = [k for k in cols]
    jspec = jb.MODELS[model]

    def jf(p_, *chans):
        return jspec.fn(p_, jb.ShadingAngles(**dict(zip(names, chans))))

    j_args = (jnp.asarray(p),) + tuple(jnp.asarray(cols[k]) for k in names)
    j_val, vjp = jax.vjp(jf, *j_args)
    j_grads = vjp(jnp.asarray(ct))

    t_args = [torch.tensor(p, requires_grad=True)] + [
        torch.tensor(cols[k], requires_grad=True) for k in names
    ]
    t_val = tb.MODELS[model].fn(t_args[0], tb.ShadingAngles(**dict(zip(names, t_args[1:]))))
    t_grads = torch.autograd.grad(t_val, t_args, grad_outputs=torch.tensor(ct),
                                  allow_unused=True, materialize_grads=True)
    return (np.asarray(j_val), [np.asarray(g) for g in j_grads],
            t_val.detach().numpy(), [g.numpy() for g in t_grads])


@pytest.mark.parametrize("model", ALL_LOBES)
def test_lobe_value_and_gradients_match_jax(model):
    rng = np.random.default_rng(11)
    t, v = 64, 16
    cols = angle_columns(rng, t, v, np.float64, tangent=jb.MODELS[model].tangent)
    p = true_params(model, rng, t, np.float64)
    ct = rng.normal(size=(t, v))
    j_val, j_grads, t_val, t_grads = _value_and_grads(model, p, cols, ct)
    assert np.isfinite(t_val).all()
    np.testing.assert_allclose(t_val, j_val, rtol=RTOL, atol=ATOL)
    for jg, tg in zip(j_grads, t_grads):
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def _edge_columns(v, tangent):
    """Texels at the clamp edges: cl = 0, cnh = 0, cvn = 0, grazing
    (cos 1e-9) and back-facing cosines, mixed across views. |cos| = 1 is
    left out: see test_oren_nayar_gradient_at_normal_incidence."""
    edge = np.array([0.0, 1e-9, -0.3, 0.999, 0.5, 0.0, 1e-9, -0.999])
    rng = np.random.default_rng(5)
    t = 24
    cols = {
        "cos_ln": rng.choice(edge, (t, v)), "cos_nh": rng.choice(edge, (t, v)),
        "cos_rv": rng.choice(edge, (t, v)), "cos_vn": rng.choice(edge, (t, v)),
    }
    cols["cos_ln"][0] = 0.0
    cols["cos_nh"][1] = 0.0
    cols["cos_vn"][2] = 0.0
    if tangent:
        cols.update({k: rng.choice(edge, (t, v)) for k in TANGENT})
    return cols, t


@pytest.mark.parametrize("model", ALL_LOBES)
def test_lobe_nan_guards_hold_at_edges(model):
    """The masks keep values and gradients finite at cl = 0, cnh = 0 and at
    grazing angles, and the port's clamp subgradients are JAX's (a tie at a
    clamp splits the gradient in both)."""
    v = 16
    cols, t = _edge_columns(v, jb.MODELS[model].tangent)
    p = true_params(model, np.random.default_rng(3), t, np.float64)
    ct = np.random.default_rng(4).normal(size=(t, v))
    j_val, j_grads, t_val, t_grads = _value_and_grads(model, p, cols, ct)
    assert np.isfinite(t_val).all()
    for tg in t_grads:
        assert np.isfinite(tg).all()
    np.testing.assert_allclose(t_val, j_val, rtol=RTOL, atol=ATOL)
    # at cosines of 1e-9 some partials reach 1e20 through ratios like sin/cos
    # and 1/cos², and 1 − c² style terms cancel: each array is held to 1e-5
    # relative, plus float64 rounding at the scale of its largest entry
    for jg, tg in zip(j_grads, t_grads):
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=max(1e-9, 1e-13 * scale))


def test_oren_nayar_gradient_at_normal_incidence():
    """A fault of the reference, ported as it is: Oren-Nayar's gradient is
    NaN at |cos| = 1 (sqrt's infinite slope at sin = 0 times a zero), in
    JAX and in the port alike."""
    cols = {k: np.full((1, 2), 0.5) for k in ("cos_ln", "cos_nh", "cos_rv", "cos_vn")}
    cols["cos_ln"][0] = (1.0, -1.0)
    p = np.array([[0.5, 0.5]])
    ct = np.ones((1, 2))
    _, j_grads, t_val, t_grads = _value_and_grads("oren_nayar", p, cols, ct)
    assert np.isfinite(t_val).all()
    assert np.isnan(np.asarray(j_grads[1])).all() and np.isnan(t_grads[1]).all()


def test_registry_matches_jax():
    assert set(tb.MODELS) == set(jb.MODELS)
    for name, js in jb.MODELS.items():
        ts = tb.MODELS[name]
        assert (ts.name, ts.n_params, ts.param_names, ts.p0, ts.lower, ts.upper,
                ts.linear, ts.tangent) == (js.name, js.n_params, js.param_names, js.p0,
                                           tuple(js.lower), tuple(js.upper), js.linear,
                                           js.tangent)


def test_shading_angles_match_jax():
    """Angles from geometry (icosphere texels lit by the LED rig), in torch
    and in the copied numpy builders, against the JAX builders."""
    verts, faces = icosphere(2)
    pts = verts[faces].mean(1) * 100.0
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    eye = np.array([0.0, 0.0, 600.0])
    lights = led_rig_positions()
    ja = jb.shading_angles(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(eye),
                           jnp.asarray(lights))
    ta = tb.shading_angles(torch.tensor(pts), torch.tensor(nrm), torch.tensor(eye),
                           torch.tensor(lights))
    na = tb.angles_from_geometry_np(tb.shading_geometry_np(pts, nrm, eye, lights),
                                    dtype=np.float64)
    ja_np = jb.angles_from_geometry_np(jb.shading_geometry_np(pts, nrm, eye, lights),
                                       dtype=np.float64)
    for name in ("cos_ln", "cos_nh", "cos_rv", "cos_vn"):
        ref = np.asarray(getattr(ja, name))
        np.testing.assert_allclose(getattr(ta, name).numpy(), ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(getattr(na, name), getattr(ja_np, name))
    assert ta.cos_th is None


def test_tangent_frame_waits_for_its_slice():
    """The tangent-frame channels no longer wait: both twins fill them (their
    values are held against the JAX package in test_torch_fit_lm.py), and
    neither does the rest of models/normalmap.py, the joint tier
    (test_torch_normalmap.py)."""
    g = tb.shading_geometry_np(np.zeros((2, 3)), np.array([[0, 0, 1.0]] * 2),
                               np.array([0, 0, 5.0]), np.ones((3, 3)))
    na = tb.angles_from_geometry_np(g, tangent_frame=True)
    ta = tb.shading_angles(torch.zeros(2, 3), torch.tensor([[0, 0, 1.0]] * 2),
                           torch.tensor([0, 0, 5.0]), torch.ones(3, 3), tangent_frame=True)
    for name in ("cos_th", "cos_bh", "cos_tl", "cos_bl", "cos_tv", "cos_bv"):
        assert getattr(na, name).shape == (2, 3) and getattr(ta, name).shape == (2, 3)
        np.testing.assert_allclose(getattr(ta, name).numpy(), getattr(na, name), atol=1e-6)
    from brdf_tpu_torch.models import normalmap
    assert callable(normalmap.joint_residual) and normalmap.joint_spec().n_params == 9


def test_convert_round_trips_angles():
    cols = angle_columns(np.random.default_rng(0), 8, 4)
    ta = convert.from_numpy(jb.ShadingAngles(**cols))
    assert isinstance(ta, tb.ShadingAngles) and ta.cos_ln.dtype == torch.float32
    back = convert.to_numpy(ta)
    for k, x in cols.items():
        np.testing.assert_array_equal(getattr(back, k), x)
