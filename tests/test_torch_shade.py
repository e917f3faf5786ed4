"""``brdf_tpu_torch.ops.shading.shade`` (kernels K2–K4, on the CPU their plain
versions) against ``shade_pallas(interpret=True)`` and ``MODELS[m].fn`` of
the JAX package on the same seeded numpy inputs, with the bars of
``tests/test_shading_pallas.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.ops.shading_pallas import shade_pallas  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS as T_MODELS, ShadingAngles as TAngles  # noqa: E402
from brdf_tpu_torch.ops import shading as ops  # noqa: E402
from torch_port_inputs import ALL_LOBES, TANGENT  # noqa: E402


def make_case(model, t=517, v=16, seed=0):
    """``tests/test_shading_pallas.py::make_case`` as numpy: full-range
    cosines (a continuous draw, so never exactly ±1, where oren_nayar's
    gradient is NaN in both packages)."""
    rng = np.random.default_rng(seed)
    spec = J_MODELS[model]
    cols = {}
    if spec.tangent:
        cols = {name: rng.uniform(-1, 1, (t, v)) for name in TANGENT}
    cols = dict(
        cos_ln=rng.uniform(-1, 1, (t, v)), cos_nh=rng.uniform(-1, 1, (t, v)),
        cos_rv=rng.uniform(-1, 1, (t, v)), cos_vn=rng.uniform(0.05, 1, (t, v)), **cols)
    pcols = []
    for lo, hi, name in zip(spec.lower, spec.upper, spec.param_names):
        if name == "n":
            pcols.append(rng.uniform(1.0, 30.0, t))
        elif name == "phi":
            pcols.append(rng.uniform(-1.2, 1.2, t))
        else:
            pcols.append(rng.uniform(max(lo, 0.05), min(hi, 1.0), t))
    return (np.stack(pcols, -1).astype(np.float32),
            {k: x.astype(np.float32) for k, x in cols.items()})


def j_inputs(params, cols):
    return jnp.asarray(params), JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})


def t_inputs(params, cols, grad=False, dtype=torch.float32):
    p = torch.tensor(params, dtype=dtype, requires_grad=grad)
    return p, TAngles(**{k: torch.tensor(x, dtype=dtype, requires_grad=grad)
                         for k, x in cols.items()})


@pytest.mark.parametrize("model", ALL_LOBES)
def test_forward_matches_pallas_and_model(model):
    params, cols = make_case(model)
    got = ops.shade(model, *t_inputs(params, cols))
    assert got.shape == (517, 16) and got.dtype == torch.float32
    jp, ja = j_inputs(params, cols)
    np.testing.assert_allclose(got.numpy(), shade_pallas(model, jp, ja, interpret=True),
                               rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), J_MODELS[model].fn(jp, ja), rtol=3e-5, atol=1e-6)


@pytest.mark.parametrize("model", ALL_LOBES)
def test_vjp_matches_pallas_vjp(model):
    """Parameter cotangents and every angle-channel cotangent against
    ``jax.vjp`` of ``shade_pallas``; a channel the lobe does not read takes no
    part in the port's graph and gets ``None``."""
    params, cols = make_case(model, seed=1)
    ct = np.random.default_rng(2).normal(size=(517, 16)).astype(np.float32)
    jp, ja = j_inputs(params, cols)
    out_ref, vjp_ref = jax.vjp(lambda p, a: shade_pallas(model, p, a, interpret=True), jp, ja)
    dp_ref, dang_ref = vjp_ref(jnp.asarray(ct))

    p, ang = t_inputs(params, cols, grad=True)
    out = ops.shade(model, p, ang)
    names = [k for k in TAngles._fields if getattr(ang, k) is not None]
    grads = torch.autograd.grad(out, [p] + [getattr(ang, k) for k in names], torch.tensor(ct),
                                allow_unused=True)
    np.testing.assert_allclose(out.detach().numpy(), out_ref, rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), dp_ref, rtol=2e-4, atol=2e-4)
    read = set(ops.SHADING_KERNELS[model].angle_names)
    for name, g in zip(names, grads[1:]):
        ref = getattr(dang_ref, name)
        if name not in read:
            # JAX hands back zeros for a channel that was given and not read
            assert g is None and not np.any(ref), f"{model} d/d{name}"
            continue
        assert g.shape == (517, 16)
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{model} d/d{name}")


@pytest.mark.parametrize("model", ALL_LOBES)
def test_grad_of_fit_loss(model):
    """The gradient of ``0.5·Σ(shade(p, a) − y)²`` reaches parameters and
    angles, against ``jax.grad`` through the jnp model."""
    params, cols = make_case(model, t=260, seed=4)
    jp, ja = j_inputs(params, cols)
    target = np.asarray(J_MODELS[model].fn(jp, ja))
    p0 = params * 0.8 + 0.05

    def loss_ref(p, a):
        return 0.5 * jnp.sum((J_MODELS[model].fn(p, a) - target) ** 2)

    r_p, r_a = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(p0), ja)
    p, ang = t_inputs(p0, cols, grad=True)
    loss = 0.5 * torch.sum((ops.shade(model, p, ang) - torch.tensor(target)) ** 2)
    g_p, g_ln = torch.autograd.grad(loss, [p, ang.cos_ln])
    np.testing.assert_allclose(g_p.numpy(), r_p, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(g_ln.numpy(), r_a.cos_ln, rtol=2e-3, atol=2e-3)
    assert torch.isfinite(g_p).all()


@pytest.mark.parametrize("t", [1, 7, 128, 129])
def test_small_and_odd_batches(t):
    params, cols = make_case("blinn_phong", t=t, v=8, seed=t)
    got = ops.shade("blinn_phong", *t_inputs(params, cols))
    jp, ja = j_inputs(params, cols)
    np.testing.assert_allclose(got.numpy(), shade_pallas("blinn_phong", jp, ja, interpret=True),
                               rtol=3e-5, atol=1e-6)


def test_hundreds_of_views():
    params, cols = make_case("cook_torrance", t=300, v=600, seed=21)
    p, ang = t_inputs(params, cols, grad=True)
    got = ops.shade("cook_torrance", p, ang)
    jp, ja = j_inputs(params, cols)
    np.testing.assert_allclose(got.detach().numpy(), J_MODELS["cook_torrance"].fn(jp, ja),
                               rtol=1e-4, atol=1e-6)
    (g_p,) = torch.autograd.grad(got.sum(), [p])
    r_p = jax.grad(lambda q: jnp.sum(J_MODELS["cook_torrance"].fn(q, ja)))(jp)
    np.testing.assert_allclose(g_p.numpy(), r_p, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("model", ALL_LOBES)
def test_plain_versions_match_autograd_float64(model):
    """The three plain versions on views-major float64 stacks against
    ``torch.autograd`` through ``models/brdf.py``: they carry the same
    derivatives, written out by hand."""
    params, cols = make_case(model, t=96, v=12, seed=5)
    p, ang = t_inputs(params, cols, grad=True, dtype=torch.float64)
    ct = torch.tensor(np.random.default_rng(6).normal(size=(96, 12)))
    names = ops.SHADING_KERNELS[model].angle_names
    out = T_MODELS[model].fn(p, ang)
    grads = torch.autograd.grad(out, [p] + [getattr(ang, k) for k in names], ct)

    a_st = torch.stack([getattr(ang, k).detach().T for k in names])        # (A, V, T)
    p_rows = p.detach().T.contiguous()                                      # (m, T)
    ct_vt = ct.T.contiguous()
    i_val = ops.shade_fwd_plain(model, a_st, p_rows)
    d_p = ops.shade_bwd_params_plain(model, a_st, p_rows, ct_vt)
    d_a = ops.shade_bwd_angles_plain(model, a_st, p_rows, ct_vt)
    assert i_val.shape == (12, 96) and d_p.shape == p_rows.shape and d_a.shape == a_st.shape
    torch.testing.assert_close(i_val.T, out.detach(), rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(d_p.T, grads[0], rtol=1e-8, atol=1e-10)
    for a, g in enumerate(grads[1:]):
        torch.testing.assert_close(d_a[a].T, g, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("want", ["params", "angles", "both"])
def test_needs_input_grad_decides_which_backward_runs(want, monkeypatch):
    """K3 (or its plain version) runs only for a parameter gradient, K4 only
    for an angle gradient."""
    calls = {k: 0 for k in ops._SHADE_PLAIN}
    for kernel, fn in list(ops._SHADE_PLAIN.items()):
        def counted(*args, _kernel=kernel, _fn=fn):
            calls[_kernel] += 1
            return _fn(*args)
        monkeypatch.setitem(ops._SHADE_PLAIN, kernel, counted)
    params, cols = make_case("ward", t=33, v=5, seed=8)
    p = torch.tensor(params, requires_grad=want in ("params", "both"))
    ang = TAngles(**{k: torch.tensor(x, requires_grad=want in ("angles", "both"))
                     for k, x in cols.items()})
    y = torch.zeros(33, 5)
    loss = 0.5 * torch.sum((ops.shade("ward", p, ang) - y) ** 2)
    assert calls == {"fwd": 1, "bwd_params": 0, "bwd_angles": 0}
    loss.backward()
    assert calls == {"fwd": 1, "bwd_params": int(want != "angles"),
                     "bwd_angles": int(want != "params")}
    assert (p.grad is not None) == (want != "angles")
    assert (ang.cos_ln.grad is not None) == (want != "params")
    assert ang.cos_rv.grad is None                      # ward does not read R·V
    assert ops.SHADE_LAUNCHES == {"fwd": 0, "bwd_params": 0, "bwd_angles": 0}


def test_bwd_params_sums_views_left_to_right():
    """K3's contract: float32 sums over views from view 0 upward, so that the
    kernel and this version can be held to equality on the card."""
    params, cols = make_case("phong", t=40, v=16, seed=9)
    names = ops.SHADING_KERNELS["phong"].angle_names
    a_st = torch.stack([torch.tensor(cols[k]).T for k in names])
    p_rows = torch.tensor(params).T.contiguous()
    ct = torch.tensor(np.random.default_rng(10).normal(size=(16, 40)).astype(np.float32))
    _, d_p, _ = ops.shading_eval_plain("phong", a_st, p_rows)
    want = torch.zeros(3, 40)
    for v in range(16):
        want = want + d_p[:, v] * ct[v]
    assert torch.equal(ops.shade_bwd_params_plain("phong", a_st, p_rows, ct), want)


def test_shade_rejects_what_it_cannot_take():
    params, cols = make_case("ward_aniso", t=9, v=4)
    p, ang = t_inputs(params, cols)
    with pytest.raises(ValueError, match="tangent_frame=True"):
        ops.shade("ward_aniso", p, ang._replace(cos_th=None))
    with pytest.raises(ValueError, match="params of shape"):
        ops.shade("ward_aniso", p[:, :3], ang)
    a_st = torch.zeros(2, 4, 9)
    with pytest.raises(ValueError, match="float32 CUDA"):     # a CPU tensor never launches
        ops.shade_fwd_cuda("blinn_phong", a_st, torch.zeros(3, 9))
    with pytest.raises(ValueError, match="float32 CUDA"):
        ops.shade_bwd_params_cuda("blinn_phong", a_st, torch.zeros(3, 9), torch.zeros(4, 9))
    with pytest.raises(ValueError, match="float32 CUDA"):
        ops.shade_bwd_angles_cuda("blinn_phong", a_st, torch.zeros(3, 9), torch.zeros(4, 9))
