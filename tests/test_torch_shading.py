"""The plain lobe library (brdf_tpu_torch/ops/shading.py, the CPU twin of
csrc/lobes.cuh) against ``SHADING_KERNELS[m].eval`` of the JAX package,
called directly on (V, T) arrays in float64."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.ops.shading_pallas import SHADING_KERNELS as J_KERNELS  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS as T_KERNELS  # noqa: E402
from torch_port_inputs import SEPARABLE, angle_columns, true_params  # noqa: E402

# both sides evaluate the same expressions in float64; the port writes a
# division by a constant as a multiply by its reciprocal, which moves the
# last bit, and exp/log differ by an ulp between XLA and torch
RTOL = 1e-10


def _inputs(model, edges: bool):
    rng = np.random.default_rng(7)
    t, v = 96, 16
    cols = angle_columns(rng, t, v, np.float64)
    if edges:   # clamp edges: exact zeros, grazing and back-facing cosines
        pick = np.array([0.0, 1e-9, -0.2, 0.999])
        for name in cols:
            mask = rng.uniform(size=(t, v)) < 0.3
            cols[name][mask] = rng.choice(pick, mask.sum())
    params = true_params(model, rng, t, np.float64)
    names = T_KERNELS[model].angle_names
    ang = [cols[n].T.copy() for n in names]                      # (V, T)
    prm = [params[:, j][None, :].copy() for j in range(3)]      # (1, T)
    return ang, prm


@pytest.mark.parametrize("edges", [False, True], ids=["interior", "edges"])
@pytest.mark.parametrize("model", SEPARABLE)
def test_plain_lobe_matches_pallas_library(model, edges):
    ang, prm = _inputs(model, edges)
    j_i, j_dp, j_da = J_KERNELS[model].eval(
        tuple(jnp.asarray(a) for a in ang), tuple(jnp.asarray(p) for p in prm))
    t_i, t_dp, t_da = T_KERNELS[model].eval(
        tuple(torch.tensor(a) for a in ang), tuple(torch.tensor(p) for p in prm))
    assert T_KERNELS[model].angle_names == J_KERNELS[model].angle_names
    assert len(t_dp) == len(j_dp) == 3 and len(t_da) == len(j_da)
    for j, t in zip((j_i, *j_dp, *j_da), (t_i, *t_dp, *t_da)):
        t = t.numpy()
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=1e-12)


def test_lobe_ids_are_distinct():
    """The selector each spec hands to csrc/lobes.cuh's lobe_full<L>."""
    assert sorted(s.lobe_id for s in T_KERNELS.values()) == list(range(10))
    assert [T_KERNELS[m].lobe_id for m in SEPARABLE] == [0, 1, 2, 3]
    assert set(T_KERNELS) == set(J_KERNELS)
