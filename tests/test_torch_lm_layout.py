"""K5's lane layout (brdf_tpu_torch/ops/lm.py::lane_layout) and the plain
version's sums in that layout's order (ops/lanegroup.py::group_sum), on the
CPU.

On the card K5 solves a texel with a group of S lanes, lane l holding views
l, l + S, …, and hands texels to groups as they finish theirs. The plain
version repeats the layout's sum order, so that the two agree bit for bit
there; here it is held to the layout rule, to the JAX package's
``levmar_bc`` in float64 by outcome at one, two and 37 views with a ragged
texel count, and to the contract the refill rests on: a lane's result is
its own, whatever the other lanes do and in whatever order the lanes come."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions, levmar_bc as j_levmar_bc  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS  # noqa: E402
from brdf_tpu_torch.ops import lanegroup, lm as k5, varpro_nd as k8  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions, StopReason  # noqa: E402
from torch_port_inputs import ALL_LOBES, angle_columns, true_params  # noqa: E402

OPTS = dict(eps1=1e-9, eps2=1e-9, eps3=1e-14, itmax=60)
CONVERGED = (1, 2, 6)
T_RAGGED = 45          # not a multiple of any layout's texels a block
# the largest view count fits_fused admits, by angle channels
LARGEST = {1: 605, 2: 454, 3: 363, 4: 302, 5: 259, 9: 165}


@pytest.mark.parametrize("v", [1, 2, 16, 37, "largest", "past"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_lane_layout(model, v):
    """S lanes a texel (a power of two dividing 32, the fewest that leave a
    lane at most ``views_per_lane`` views, else 32), VPL = ⌈V/S⌉, 128 / S
    texels a block; at V=16 (4, 4), and (8, 2) for the two-channel lobes.
    The views sit in VPL register slots while they take at most
    REGISTER_FLOATS floats, else in shared memory (33 KB a block at most);
    the largest view count routed to K5 has a layout, one more raises
    towards the chunked tier."""
    a_count = len(SHADING_KERNELS[model].angle_names)
    v_max = LARGEST[a_count]
    assert k5.fits_fused(a_count, v_max) and not k5.fits_fused(a_count, v_max + 1)
    if v == "past":
        with pytest.raises(ValueError, match="lm_fit_chunked"):
            k5.lane_layout(a_count, v_max + 1)
        return
    v = v_max if v == "largest" else v
    lanes, vpl, block_t = k5.lane_layout(a_count, v)
    per_lane = k5.views_per_lane(a_count)
    assert per_lane == (2 if a_count == 2 else 4)
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes * block_t == k5.THREADS
    assert vpl == -(-v // lanes) and (vpl - 1) * lanes < v <= vpl * lanes
    assert lanes == lanegroup.group_lanes(v, per_lane)
    assert vpl <= per_lane or lanes == 32
    assert lanes == 1 or -(-v // (lanes // 2)) > per_lane     # no fewer lanes would do
    if v == 16:
        assert (lanes, vpl) == ((8, 2) if a_count == 2 else (4, 4))
    slots = k5.register_slots(a_count, vpl)
    if vpl * (a_count + 2) <= k5.REGISTER_FLOATS:
        assert slots == vpl in (1, 2)
    else:
        assert slots == 0 and k5.THREADS * (a_count + 2) * vpl * 4 <= 33792
    if v == v_max:
        assert slots == 0 and lanes == 32


def test_one_lane_group_sum_for_k5_and_k8(monkeypatch):
    """K5 and K8 share one plain lane-order sum, and K5's plain version sums
    every view quantity with it at ``lane_layout``'s layout: χ² of the start,
    the JᵀJ upper triangle, Jᵀr and the trial χ² of each iteration."""
    assert k5.group_sum is lanegroup.group_sum and k8.group_sum is lanegroup.group_sum
    model, v = "cook_torrance", 37
    _, _, ta, target, p0, _ = _problem(model, v, seed=3)
    seen = []

    def spy(x, lanes, vpl):
        seen.append((x.shape[0], lanes, vpl))
        return lanegroup.group_sum(x, lanes, vpl)

    monkeypatch.setattr(k5, "group_sum", spy)
    r = _fused(model, ta, target, p0, dict(OPTS, itmax=1))
    m = MODELS[model].n_params
    assert int(r.iters.max()) == 1
    assert len(seen) == 1 + (m * (m + 1) // 2 + m) + 1
    assert set(seen) == {(v, *k5.lane_layout(3, v)[:2])}


@pytest.mark.parametrize("model", ["blinn_phong", "ward_aniso"])
def test_plain_k5_group_order_matches_left_to_right_float64(model, monkeypatch):
    """In float64 one LM iteration in the lane order agrees with the same
    iteration summed left to right (one lane holding every view) within
    1e-12 on every lane and every output row."""
    rng = np.random.default_rng(21)
    cols = angle_columns(rng, T_RAGGED, 37, dtype=np.float64, tangent=MODELS[model].tangent)
    ta = convert.from_numpy(JAngles(**cols))
    true_p = true_params(model, rng, T_RAGGED, np.float64)
    spec = MODELS[model]
    with torch.no_grad():
        y = spec.fn(torch.tensor(true_p), ta) * (1.0 + 0.01 * torch.tensor(
            rng.standard_normal((T_RAGGED, 37))))
        p0 = torch.clamp(torch.tensor(true_p * rng.uniform(0.8, 1.25, true_p.shape)),
                         torch.tensor(spec.lower, dtype=torch.float64),
                         torch.tensor(spec.upper, dtype=torch.float64))
    ang = torch.stack([getattr(ta, n).T for n in SHADING_KERNELS[model].angle_names]).contiguous()
    rows = torch.zeros((8, T_RAGGED), dtype=torch.float64)
    rows[:spec.n_params] = p0.T
    cfg = k5.config(model, LMOptions(**dict(OPTS, itmax=1)), spec.lower, spec.upper)
    inputs = (ang, y.T.contiguous(), torch.ones_like(y.T).contiguous(), rows)
    assert k5.lane_layout(ang.shape[0], 37)[0] > 1
    grouped = k5.lm_rows_plain(cfg, *inputs).numpy()
    monkeypatch.setattr(k5, "lane_layout", lambda a, v: (1, v, k5.THREADS))
    serial = k5.lm_rows_plain(cfg, *inputs).numpy()
    assert grouped.dtype == np.float64
    np.testing.assert_allclose(grouped, serial, rtol=1e-12, atol=1e-12)


def _problem(model, v, seed, t=T_RAGGED):
    """Exact targets from known parameters and a start 20% off the truth,
    as float64 numpy arrays and as the float32 tensors the port takes."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v, dtype=np.float64, tangent=MODELS[model].tangent)
    ja = JAngles(**{k: jnp.asarray(x) for k, x in cols.items()})
    true_p = true_params(model, rng, t, np.float64)
    target = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), ja))
    spec = MODELS[model]
    p0 = np.clip(true_p * rng.uniform(0.8, 1.25, true_p.shape), spec.lower, spec.upper)
    ta = convert.from_numpy(JAngles(**{k: x.astype(np.float32) for k, x in cols.items()}))
    return ja, target, ta, target.astype(np.float32), p0.astype(np.float32), true_p


def _fused(model, ta, target, p0, opts, warm=None):
    spec = MODELS[model]
    return k5.lm_fit_fused(model, ta, torch.tensor(target), torch.tensor(p0),
                           opts=LMOptions(**opts), lower=tuple(spec.lower),
                           upper=tuple(spec.upper), warm=warm)


@pytest.mark.parametrize("model,v", [("lambert", 1), ("minnaert", 2), ("cook_torrance", 37)])
def test_plain_k5_matches_levmar_bc_in_float64_by_outcome(model, v):
    """One, two and 37 views (S = 1, 1 and 16 lanes, the last with a ragged
    slot), T = 45: the plain K5 in float32 and the JAX package's
    ``levmar_bc`` in float64 from the same start converge the same share of
    lanes (within 0.05), both reach the float32 floor of χ², and on the lanes
    both converged the parameters agree to 1e-3 relative on ≥ 95%."""
    ja, target64, ta, target, p0, true_p = _problem(model, v, seed=30 + v)
    spec = MODELS[model]
    rt = _fused(model, ta, target, p0, OPTS)
    rj = j_levmar_bc(lambda p, d: J_MODELS[model].fn(p, d[0]) - d[1],
                     jnp.asarray(p0.astype(np.float64)), spec.lower, spec.upper,
                     data=(ja, jnp.asarray(target64)), opts=JOptions(**OPTS))
    st, sj = rt.stop.numpy(), np.asarray(rj.stop)
    conv_t, conv_j = np.isin(st, CONVERGED), np.isin(sj, CONVERGED)
    assert rt.p.shape == (T_RAGGED, spec.n_params) and np.isfinite(rt.p.numpy()).all()
    assert abs(conv_t.mean() - conv_j.mean()) <= 0.05 and conv_t.mean() >= 0.8
    ct = rt.chi2.numpy()
    assert np.median(ct) < 1e-9 and np.median(np.asarray(rj.chi2)) < 1e-12
    both = conv_t & conv_j
    pt, pj = rt.p.numpy()[both], np.asarray(rj.p)[both]
    rel = (np.abs(pt - pj) / np.maximum(np.abs(pj), 1e-3)).max(-1)
    assert (rel < 1e-3).mean() >= 0.95


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance_aniso"])
def test_a_lane_keeps_its_state_whatever_the_others_do(model):
    """The contract K5's groups rest on (they leave a stopped texel and take
    another): a lane that has stopped keeps its state while the others
    iterate, so a lane solved with others equals it solved alone, lanes in
    another order give the same lanes in that order, and a lane that comes in
    stopped (warm stop ≠ 0) is returned as it came, with no iteration."""
    _, _, ta, target, p0, _ = _problem(model, 16, seed=40)
    spec = MODELS[model]
    cfg = k5.config(model, LMOptions(**OPTS), spec.lower, spec.upper)
    ang, y, w, rows = k5.stack_inputs(model, ta, torch.tensor(target), torch.tensor(p0))
    rows[7, 1::5] = float(StopReason.SMALL_DP)          # warm-stopped lanes
    out = k5.lm_rows_plain(cfg, ang, y, w, rows)
    iters = out[6]
    assert float(iters.min()) != float(iters.max())    # lanes stop at different iterations
    assert bool((iters[1::5] == 0).all()) and bool((out[7, 1::5] == 2.0).all())
    torch.testing.assert_close(out[:5, 1::5], rows[:5, 1::5], rtol=0, atol=0)
    perm = torch.tensor(np.random.default_rng(41).permutation(T_RAGGED))
    shuffled = k5.lm_rows_plain(cfg, ang[:, :, perm], y[:, perm], w[:, perm], rows[:, perm])
    torch.testing.assert_close(shuffled, out[:, perm], rtol=0, atol=0, equal_nan=True)
    for lane in (0, int(torch.argmin(iters)), int(torch.argmax(iters))):
        alone = k5.lm_rows_plain(cfg, ang[:, :, lane:lane + 1], y[:, lane:lane + 1],
                                 w[:, lane:lane + 1], rows[:, lane:lane + 1])
        torch.testing.assert_close(alone[:, 0], out[:, lane], rtol=0, atol=0, equal_nan=True)
