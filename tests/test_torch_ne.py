"""K6's plain version (brdf_tpu_torch/ops/ne.py::ne_rows_plain, what the CPU
path runs) against the JAX package's normal-equation kernel in interpret
mode (``_ne_call``, ``shading_value_and_grad_pallas``) on the same numpy
inputs, float32; and against ``torch.autograd`` of the port's lobes in
float64.

The TPU kernel sums a view chunk and then adds chunks, the port sums the
views left to right, and XLA's exp/log differ from torch's by an ulp, so the
bars are those of tests/test_lm_chunked.py: χ² rtol 2e-5, atol 1e-6; g rtol
5e-4, atol 5e-5; JᵀJ rows rtol 1e-3 (atol 1e-5 of the row's scale). N·H is
drawn in [0, 0.95]: at N·H → 1 and a small roughness the GGX denominator
``nh²(a²−1)+1`` cancels to a few ulps, one rounding of ``nh²`` then moves the
lobe by 1e-4 relative, and no bar on a sum of squares holds there."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.ops.lm_pallas import _ne_call, shading_value_and_grad_pallas  # noqa: E402
from brdf_tpu.ops.shading_pallas import SHADING_KERNELS as J_KERNELS  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles  # noqa: E402
from brdf_tpu_torch.ops import ne  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS  # noqa: E402
from torch_port_inputs import ALL_LOBES, angle_columns, true_params  # noqa: E402

SHAPES = ((1, 5), (70, 13), (129, 5))


def _case(model, t, v, seed, weighted):
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v, tangent=MODELS[model].tangent)
    cols["cos_nh"] = cols["cos_nh"] * np.float32(0.95)
    true_p = true_params(model, rng, t)
    spec = MODELS[model]
    params = np.clip(true_p * rng.uniform(0.8, 1.2, true_p.shape), spec.lower, spec.upper)
    ta = convert.from_numpy(JAngles(**cols))
    with torch.no_grad():
        target = spec.fn(torch.tensor(true_p), ta).numpy() + rng.normal(0, 0.02, (t, v))
    w = rng.uniform(0.2, 1.0, (t, v)).astype(np.float32) if weighted else None
    return cols, ta, target.astype(np.float32), params.astype(np.float32), w


def _jax_rows(model, mode, cols, target, params, w):
    """``_ne_call`` in interpret mode on inputs padded as its callers pad."""
    spec = J_KERNELS[model]
    t, v = target.shape
    pad_t = (-t) % 128

    def prep(x):
        return jnp.pad(jnp.asarray(x, jnp.float32).T, ((0, 0), (0, pad_t)))

    ang = jnp.stack([prep(cols[n]) for n in spec.angle_names])
    p_rows = jnp.pad(jnp.asarray(params).T, ((0, 8 - spec.n_params), (0, pad_t)))
    out = _ne_call(spec, ang, prep(target), None if w is None else prep(w), p_rows, 128, v,
                   mode, True)
    return np.asarray(out)[:ne.ne_rows_count(spec.n_params, mode), :t]


def _port_rows(model, mode, ta, target, params, w, dtype=torch.float32):
    spec = SHADING_KERNELS[model]
    ang = torch.stack([getattr(ta, n).to(dtype).T for n in spec.angle_names]).contiguous()
    as_vt = lambda x: torch.tensor(x, dtype=dtype).T.contiguous()  # noqa: E731
    return ne.ne_rows(model, mode, ang, as_vt(target), None if w is None else as_vt(w),
                      as_vt(params))


def _assert_rows(got, ref, m, mode):
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5, atol=1e-6)
    if mode == "chi2":
        return
    np.testing.assert_allclose(got[-m:], ref[-m:], rtol=5e-4, atol=5e-5)
    if mode == "full":
        a_got, a_ref = got[1:-m], ref[1:-m]
        scale = np.abs(a_ref).max(axis=1, keepdims=True)
        off = np.abs(a_got - a_ref) - (1e-3 * np.abs(a_ref) + 1e-5 * scale + 1e-7)
        assert (off <= 0).all(), (off.max(), np.argwhere(off > 0)[:5])


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_full_rows_match_the_pallas_kernel(model, weighted):
    """χ², the upper triangle of JᵀJ in (j, k) order and Jᵀe at T ∈ {1, 70,
    129}, V ∈ {5, 13}."""
    m = SHADING_KERNELS[model].n_params
    for i, (t, v) in enumerate(SHAPES):
        cols, ta, target, params, w = _case(model, t, v, 10 + i, weighted)
        got = _port_rows(model, "full", ta, target, params, w).numpy()
        assert got.shape == (1 + m * (m + 1) // 2 + m, t)
        _assert_rows(got, _jax_rows(model, "full", cols, target, params, w), m, "full")


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_chi2_and_grad_rows_match_and_are_rows_of_full(model, weighted):
    """The ``chi2`` and ``grad`` modes against the kernel, and within the port
    bit for bit the rows that ``full`` also gives."""
    m = SHADING_KERNELS[model].n_params
    cols, ta, target, params, w = _case(model, 70, 13, 20, weighted)
    full = _port_rows(model, "full", ta, target, params, w)
    for mode in ("chi2", "grad"):
        got = _port_rows(model, mode, ta, target, params, w)
        assert got.shape == (ne.ne_rows_count(m, mode), 70)
        _assert_rows(got.numpy(), _jax_rows(model, mode, cols, target, params, w), m, mode)
        assert torch.equal(got[0], full[0])
        if mode == "grad":
            assert torch.equal(got[1:], full[-m:])


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "ward_aniso"])
def test_shading_value_and_grad_matches_the_pallas_function(model):
    """The public loss-and-gradient function against
    ``shading_value_and_grad_pallas(interpret=True)``, weighted and not."""
    t, v = 70, 5
    cols, ta, target, params, w = _case(model, t, v, 30, True)
    ja = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    for weights in (w, None):
        chi2_j, g_j = shading_value_and_grad_pallas(
            model, jnp.asarray(params), ja, jnp.asarray(target),
            weights=None if weights is None else jnp.asarray(weights),
            block_t=128, view_block=5, interpret=True)
        chi2, g = ne.shading_value_and_grad(
            model, torch.tensor(params), ta, torch.tensor(target),
            weights=None if weights is None else torch.tensor(weights))
        assert chi2.shape == (t,) and g.shape == (t, SHADING_KERNELS[model].n_params)
        np.testing.assert_allclose(chi2.numpy(), np.asarray(chi2_j), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_normal_equations_unfold_the_full_rows(model, weighted):
    """``normal_equations`` (what ``FitReport.statistics`` reads): χ² and
    the symmetric (T, m, m) JᵀJ, bit for bit the ``full`` rows it unfolds."""
    t, v = 70, 13
    m = SHADING_KERNELS[model].n_params
    cols, ta, target, params, w = _case(model, t, v, 35, weighted)
    rows = _port_rows(model, "full", ta, target, params, w)
    chi2, jtj = ne.normal_equations(model, torch.tensor(params), ta, torch.tensor(target),
                                    weights=None if w is None else torch.tensor(w))
    assert chi2.shape == (t,) and jtj.shape == (t, m, m)
    assert torch.equal(chi2, rows[0])
    assert torch.equal(jtj, jtj.transpose(1, 2))
    idx = 1
    for j in range(m):
        for k in range(j, m):
            assert torch.equal(jtj[:, j, k], rows[idx])
            idx += 1


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_rows_match_autograd_of_the_lobe_in_float64(model, weighted):
    """χ² and g against ``torch.autograd`` of ``models/brdf.py``'s loss, JᵀJ
    against its forward-mode Jacobian, all in float64."""
    t, v = 33, 6
    spec = MODELS[model]
    m = spec.n_params
    cols, ta, target, params, w = _case(model, t, v, 40, weighted)
    ta64 = ShadingAngles(*(None if a is None else a.double() for a in ta))
    y = torch.tensor(target, dtype=torch.float64)
    w64 = torch.ones_like(y) if w is None else torch.tensor(w, dtype=torch.float64)
    p = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    r = (spec.fn(p, ta64) - y) * w64
    g_ref, = torch.autograd.grad(0.5 * torch.sum(r * r), p)
    dims = ShadingAngles(*(None if a is None else 0 for a in ta64))
    jac = torch.func.vmap(torch.func.jacfwd(lambda q, a: spec.fn(q, a)), in_dims=(0, dims))(
        p.detach(), ta64)                                                  # (T, V, m)
    jw = jac * w64[..., None]
    jtj = torch.einsum("tvj,tvk->tjk", jw, jw)
    got = _port_rows(model, "full", ta, target, params, w, dtype=torch.float64)
    torch.testing.assert_close(got[0], torch.sum(r * r, -1).detach(), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(got[-m:].T, g_ref, rtol=1e-9, atol=1e-12)
    idx = 1
    for j in range(m):
        for k in range(j, m):
            torch.testing.assert_close(got[idx], jtj[:, j, k], rtol=1e-9, atol=1e-12)
            idx += 1


def test_wrapper_checks_mode_device_and_shapes():
    cols, ta, target, params, w = _case("lambert", 8, 4, 50, True)
    with pytest.raises(ValueError, match="unknown mode"):
        _port_rows("lambert", "hessian", ta, target, params, w)
    ang = torch.stack([ta.cos_ln.T]).contiguous()
    y, p = torch.tensor(target).T.contiguous(), torch.tensor(params).T.contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        ne.ne_rows_cuda("lambert", "chi2", ang, y, None, p)
    with pytest.raises(ValueError, match="tangent_frame"):
        ne.shading_value_and_grad("ward_aniso", torch.zeros(8, 5), ta, torch.tensor(target))
    assert ne.LAUNCHES == {"ne": 0, "joint_ne": 0, "lm_step": 0}
    assert [ne.ne_rows_count(5, mode) for mode in ("chi2", "grad", "full")] == [1, 6, 21]
