"""K7's plain version (brdf_tpu_torch/ops/ne.py::joint_ne_rows_plain, what the
CPU path runs) against the JAX package's joint normal-equation kernel in
interpret mode (``joint_value_and_grad_pallas``, ``_joint_ne_call``) on the
same numpy inputs, float32; and against ``torch.autograd`` of the port's
``joint_eval`` in float64.

The bars are those of tests/test_joint_pallas.py: χ² rtol 5e-5, atol 1e-6; g
rtol 2e-3, atol 2e-4 (the TPU kernel sums view chunks, the port the views left
to right; the gradient passes through the normalisations of n' and H); JᵀJ
rows rtol 1e-3 with 1e-5 of the row's scale."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import ShadingGeometry as JGeometry  # noqa: E402
from brdf_tpu.models.normalmap import joint_eval as j_joint_eval, joint_spec as j_joint_spec  # noqa: E402
from brdf_tpu.ops.lm_pallas import (  # noqa: E402
    _joint_ne_call,
    _joint_prep as j_joint_prep,
    joint_value_and_grad_pallas,
)
from brdf_tpu_torch.models.brdf import ShadingGeometry  # noqa: E402
from brdf_tpu_torch.models.normalmap import joint_eval, joint_spec, tangent_basis  # noqa: E402
from brdf_tpu_torch.ops import ne  # noqa: E402
from torch_port_inputs import joint_problem  # noqa: E402

# the 12 of the 45 (j, k) entries no channel touches
ZERO_PAIRS = [(0, 1), (0, 2), (1, 2), (3, 4), (3, 5), (4, 5),
              (0, 4), (0, 5), (1, 3), (1, 5), (2, 3), (2, 4)]


def _pair_rows():
    return [(j, k) for j in range(9) for k in range(j, 9)]


def _case(base, t, v, seed, per_channel):
    geom, true_p, rng = joint_problem(t, v, seed, base)
    jg = JGeometry(**{k: jnp.asarray(x) for k, x in geom.items()})
    target = np.asarray(j_joint_eval(j_joint_spec(base), jnp.asarray(true_p), jg))
    params = (true_p * rng.uniform(0.85, 1.15, true_p.shape)).astype(np.float32)
    if per_channel:
        w = rng.uniform(0.2, 1.0, target.shape).astype(np.float32)
        w[:, 2, 1] = 0.0
    else:
        w = rng.uniform(0.2, 1.0, target.shape[:2]).astype(np.float32)
    tg = ShadingGeometry(**{k: torch.tensor(x) for k, x in geom.items()})
    return jg, tg, target, params, w


def _stacks64(tg, target, w):
    """``ne._joint_prep``'s views-major stacks in float64 (the function itself
    makes float32, the kernel's type)."""
    g = ShadingGeometry(*(x.double() for x in tg))
    vec = lambda x: x.permute(2, 1, 0)  # noqa: E731
    w3 = torch.tensor(w, dtype=torch.float64)
    w3 = w3[..., None].expand(*w3.shape, 3) if w3.ndim == 2 else w3
    tb, bb = tangent_basis(g.n)
    return (torch.cat([vec(g.l), vec(g.v)]), vec(torch.tensor(target, dtype=torch.float64)), vec(w3),
            torch.cat([g.n.T, tb.T, bb.T]))


def _port_rows(base, mode, tg, target, params, w, dtype=torch.float32):
    if dtype == torch.float32:
        lv, y, ww, frame = ne._joint_prep(tg, torch.tensor(target), torch.tensor(w))
    else:
        lv, y, ww, frame = _stacks64(tg, target, w)
    return ne.joint_ne_rows(base, mode, lv, y, ww, torch.tensor(params, dtype=dtype).T.contiguous(),
                            frame)


@pytest.mark.parametrize("per_channel", [False, True], ids=["shared_w", "per_channel_w"])
@pytest.mark.parametrize("base", ["cook_torrance", "blinn_phong", "phong"])
def test_joint_value_and_grad_matches_the_pallas_kernel(base, per_channel):
    """χ² and the nine gradient rows, the two through the angles included."""
    t, v = 70, 5
    jg, tg, target, params, w = _case(base, t, v, 1, per_channel)
    chi2_j, g_j = joint_value_and_grad_pallas(
        base, jnp.asarray(params), jg, jnp.asarray(target), weights=jnp.asarray(w),
        block_t=128, view_block=4, interpret=True)
    chi2, g = ne.joint_value_and_grad(base, torch.tensor(params), tg, torch.tensor(target),
                                      weights=torch.tensor(w))
    assert chi2.shape == (t,) and g.shape == (t, 9)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(chi2_j), rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("base", ["cook_torrance", "blinn_phong", "phong"])
def test_full_rows_match_the_pallas_kernel_and_keep_the_structural_zeros(base):
    t, v = 70, 13
    jg, tg, target, params, w = _case(base, t, v, 7, True)
    spec, lv, y, wj, geom_rows, _, _, _, pad_t, vb = j_joint_prep(
        base, jg, jnp.asarray(target), jnp.asarray(w), 128, 13)
    p_rows = jnp.pad(jnp.asarray(params).T, ((0, 16 - 9), (0, pad_t)))
    ref = np.asarray(_joint_ne_call(spec, lv, y, wj, p_rows, geom_rows, 128, vb, "full", True))
    ref = ref[:55, :t]
    got = _port_rows(base, "full", tg, target, params, w).numpy()
    assert got.shape == (55, t)
    np.testing.assert_allclose(got[0], ref[0], rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(got[46:], ref[46:], rtol=2e-3, atol=2e-4)
    a_got, a_ref = got[1:46], ref[1:46]
    scale = np.abs(a_ref).max(axis=1, keepdims=True)
    off = np.abs(a_got - a_ref) - (1e-3 * np.abs(a_ref) + 1e-5 * scale + 1e-7)
    assert (off <= 0).all(), (off.max(), np.argwhere(off > 0)[:5])
    rows = _pair_rows()
    zero_rows = [rows.index(jk) for jk in ZERO_PAIRS]
    assert len(zero_rows) == 12
    assert (a_got[zero_rows] == 0.0).all() and (a_ref[zero_rows] == 0.0).all()
    live = [i for i in range(45) if i not in zero_rows]
    assert len(live) == 33 and (np.abs(a_got[live]).max(axis=1) > 0).all()


@pytest.mark.parametrize("per_channel", [False, True], ids=["shared_w", "per_channel_w"])
@pytest.mark.parametrize("base", ne.JOINT_MODELS)
def test_rows_match_autograd_of_joint_eval_in_float64(base, per_channel):
    """χ² and g against ``torch.autograd`` of the port's ``joint_eval`` loss,
    JᵀJ against its forward-mode Jacobian, in float64, for all four base
    lobes (ward has no case on the JAX side's tests)."""
    t, v = 24, 6
    _, tg, target, params, w = _case(base, t, v, 3, per_channel)
    spec = joint_spec(base)
    g64 = ShadingGeometry(*(x.double() for x in tg))
    y = torch.tensor(target, dtype=torch.float64)
    w64 = torch.tensor(w, dtype=torch.float64)
    w64 = w64[..., None] if w64.ndim == 2 else w64
    p = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    r = (joint_eval(spec, p, g64) - y) * w64
    g_ref, = torch.autograd.grad(0.5 * torch.sum(r * r), p)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda q, n, l, e: joint_eval(spec, q, ShadingGeometry(n, l, e))))(p.detach(), *g64)
    jw = (jac * w64.expand(t, v, 3)[..., None]).reshape(t, 3 * v, 9)
    jtj = torch.einsum("tnj,tnk->tjk", jw, jw)
    got = _port_rows(base, "full", tg, target, params, w, dtype=torch.float64)
    torch.testing.assert_close(got[0], torch.sum(r * r, (1, 2)).detach(), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(got[46:].T, g_ref, rtol=1e-9, atol=1e-12)
    for i, (j, k) in enumerate(_pair_rows()):
        torch.testing.assert_close(got[1 + i], jtj[:, j, k], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("base", ne.JOINT_MODELS)
def test_chi2_and_grad_modes_are_rows_of_full(base):
    _, tg, target, params, w = _case(base, 33, 7, 4, True)
    full = _port_rows(base, "full", tg, target, params, w)
    grad = _port_rows(base, "grad", tg, target, params, w)
    chi2 = _port_rows(base, "chi2", tg, target, params, w)
    assert chi2.shape == (1, 33) and grad.shape == (10, 33)
    assert torch.equal(chi2[0], full[0]) and torch.equal(grad[0], full[0])
    assert torch.equal(grad[1:], full[46:])


def test_wrapper_checks_base_mode_device_and_weight_shapes():
    _, tg, target, params, w = _case("cook_torrance", 8, 4, 5, False)
    with pytest.raises(ValueError, match="base lobe"):
        ne.joint_value_and_grad("lambert", torch.tensor(params), tg, torch.tensor(target))
    with pytest.raises(ValueError, match="unknown mode"):
        _port_rows("cook_torrance", "hessian", tg, target, params, w)
    lv, y, ww, frame = ne._joint_prep(tg, torch.tensor(target), torch.tensor(w))
    assert lv.shape == (6, 4, 8) and y.shape == ww.shape == (3, 4, 8) and frame.shape == (9, 8)
    assert torch.equal(ww[0], ww[2])                     # a (T, V) weight serves every channel
    with pytest.raises(ValueError, match="CUDA"):
        ne.joint_ne_rows_cuda("cook_torrance", "chi2", lv, y, ww,
                              torch.tensor(params).T.contiguous(), frame)
    # no weights: ones
    chi2, _ = ne.joint_value_and_grad("cook_torrance", torch.tensor(params), tg, torch.tensor(target))
    ones, _ = ne.joint_value_and_grad("cook_torrance", torch.tensor(params), tg, torch.tensor(target),
                                      weights=torch.ones(8, 4))
    assert torch.equal(chi2, ones)
    assert ne.LAUNCHES == {"ne": 0, "joint_ne": 0, "lm_step": 0}
    assert set(ne.JOINT_MODELS) == {"blinn_phong", "phong", "cook_torrance", "ward"}
