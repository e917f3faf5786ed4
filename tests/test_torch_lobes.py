"""The six lobes that complete the plain lobe library
(brdf_tpu_torch/ops/shading.py, the CPU twin of csrc/lobes.cuh) against
``SHADING_KERNELS[m].eval`` of the JAX package in float32, and against the
port's own autograd of ``models/brdf.py`` in float64."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.ops.shading_pallas import SHADING_KERNELS as J_KERNELS  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS as T_KERNELS, shading_eval  # noqa: E402
from torch_port_inputs import ALL_LOBES, SEPARABLE, angle_columns, true_params  # noqa: E402

NEW_LOBES = tuple(m for m in ALL_LOBES if m not in SEPARABLE)
T, V = 96, 16


def _inputs(model, dtype, edges=False, seed=11):
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, T, V, dtype, tangent=True)
    if edges:   # clamp edges: exact zeros, grazing and back-facing cosines
        pick = np.array([0.0, 1e-9, -0.2, 0.999], dtype)
        for name in cols:
            mask = rng.uniform(size=(T, V)) < 0.3
            cols[name][mask] = rng.choice(pick, mask.sum())
    params = true_params(model, rng, T, dtype)
    spec = T_KERNELS[model]
    ang = [cols[n].T.copy() for n in spec.angle_names]                      # (V, T)
    prm = [params[:, j][None, :].copy() for j in range(spec.n_params)]     # (1, T)
    return cols, params, ang, prm


@pytest.mark.parametrize("edges", [False, True], ids=["interior", "edges"])
@pytest.mark.parametrize("model", NEW_LOBES)
def test_plain_lobe_matches_pallas_library_f32(model, edges):
    """float32 on both sides: the port writes integer powers as multiplies
    and a division by a constant as a multiply, and XLA's exp/log/sin/cos
    differ from torch's by an ulp, so the bar is a few float32 ulps of the
    largest term (rtol 2e-5, atol 1e-6)."""
    _, _, ang, prm = _inputs(model, np.float32, edges)
    j_i, j_dp, j_da = J_KERNELS[model].eval(
        tuple(jnp.asarray(a) for a in ang), tuple(jnp.asarray(p) for p in prm))
    t_i, t_dp, t_da = T_KERNELS[model].eval(
        tuple(torch.tensor(a) for a in ang), tuple(torch.tensor(p) for p in prm))
    assert T_KERNELS[model].angle_names == J_KERNELS[model].angle_names
    assert T_KERNELS[model].n_params == J_KERNELS[model].n_params == len(t_dp) == len(j_dp)
    assert len(t_da) == len(j_da) == len(ang)
    for name, j, t in zip(["I"] + [f"dp{k}" for k in range(len(j_dp))]
                          + [f"da{k}" for k in range(len(j_da))],
                          (j_i, *j_dp, *j_da), (t_i, *t_dp, *t_da)):
        t, j = t.numpy(), np.asarray(j)
        assert t.dtype == np.float32 and t.shape == (V, T)
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j), err_msg=name)
        ok = np.isfinite(j)
        scale = max(float(np.abs(j[ok]).max()), 1.0)
        np.testing.assert_allclose(t[ok], j[ok], rtol=2e-5, atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("model", NEW_LOBES)
def test_plain_lobe_matches_own_autograd_f64(model):
    """Value and both derivative sets against ``torch.autograd`` of the
    port's ``models/brdf.py`` lobe in float64, away from the clamp edges."""
    cols, params, ang, prm = _inputs(model, np.float64)
    spec = T_KERNELS[model]
    t_i, t_dp, t_da = spec.eval(tuple(torch.tensor(a) for a in ang),
                                tuple(torch.tensor(p) for p in prm))
    p = torch.tensor(params, requires_grad=True)
    leaves = {n: torch.tensor(cols[n], requires_grad=True) for n in spec.angle_names}
    rest = {n: torch.tensor(x) for n, x in cols.items() if n not in leaves}
    out = MODELS[model].fn(p, ShadingAngles(**leaves, **rest))           # (T, V)
    np.testing.assert_allclose(t_i.numpy().T, out.detach().numpy(), rtol=1e-10, atol=1e-13)
    # one backward per view gives ∂I[t, v]/∂p[t, :]; angles are elementwise
    g_ang = torch.autograd.grad(out.sum(), list(leaves.values()), retain_graph=True)
    for k, (name, g) in enumerate(zip(spec.angle_names, g_ang)):
        np.testing.assert_allclose(t_da[k].numpy().T, g.numpy(), rtol=1e-8, atol=1e-10,
                                   err_msg=f"{model} dI/d{name}")
    for v in range(V):
        (g_p,) = torch.autograd.grad(out[:, v].sum(), p, retain_graph=True)
        for j in range(spec.n_params):
            np.testing.assert_allclose(t_dp[j].numpy()[v], g_p.numpy()[:, j], rtol=1e-8,
                                       atol=1e-10, err_msg=f"{model} dI/dp{j} view {v}")


def test_registry_holds_all_ten_lobes_with_distinct_ids():
    """The selector each spec hands to csrc/lobes.cuh's lobe_full<L>."""
    assert set(T_KERNELS) == set(ALL_LOBES) == set(J_KERNELS) == set(MODELS)
    assert sorted(s.lobe_id for s in T_KERNELS.values()) == list(range(10))
    for name, s in T_KERNELS.items():
        assert s.name == name and s.n_params == MODELS[name].n_params


@pytest.mark.parametrize("model", ALL_LOBES)
def test_shading_eval_on_the_cpu_is_the_plain_twin(model):
    _, _, ang, prm = _inputs(model, np.float32)
    a = torch.tensor(np.stack(ang))
    p = torch.tensor(np.concatenate(prm))
    i_val, d_p, d_a = shading_eval(model, a, p)
    r_i, r_dp, r_da = T_KERNELS[model].eval(tuple(a), tuple(p[j:j + 1] for j in range(p.shape[0])))
    assert d_p.shape == (p.shape[0], V, T) and d_a.shape == a.shape
    torch.testing.assert_close(i_val, r_i, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(d_p, torch.stack(r_dp), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(d_a, torch.stack(r_da), rtol=0, atol=0, equal_nan=True)


def test_shading_eval_checks_its_inputs():
    with pytest.raises(ValueError, match="angle channels"):
        shading_eval("lambert", torch.zeros(2, 4, 8), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="parameter rows"):
        shading_eval("lambert", torch.zeros(1, 4, 8), torch.zeros(2, 8))
