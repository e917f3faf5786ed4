"""K1's lane layout (brdf_tpu_torch/ops/varpro.py::lane_layout) and the plain
version's sums in that layout's order (ops/lanegroup.py::group_sum), on the
CPU.

On the card K1 solves a texel with a group of S lanes, lane l holding views
l, l + S, … in registers. The plain version repeats the layout's sum order,
so that the two agree bit for bit there; here it is held to the layout rule,
to a left-to-right sum in float64 at every group width, and to zero-weight
views at a view count where some lanes' last slot lies past V."""

import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.ops.varpro_pallas import varpro_fit_pallas  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS  # noqa: E402
from brdf_tpu_torch.ops import lanegroup, varpro as k1  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS  # noqa: E402
from torch_port_inputs import SEPARABLE, agreement, angle_columns, true_params  # noqa: E402

T_RAGGED = 45          # not a multiple of any layout's texels a block
V_RAGGED = 37          # 37 views: the last slot of some lanes lies past V at every S > 1
# the most views the first K1 took (one thread a texel, a block of 32 texels
# staging its views in shared memory), by angle channels; every one of them
# keeps a layout
OLD_MAX_VIEWS = {2: 259, 3: 227}


def _angles(model):
    return len(SHADING_KERNELS[model].angle_names)


@pytest.mark.parametrize("v", [1, 2, 16, 37, "largest", "past"])
@pytest.mark.parametrize("model", SEPARABLE)
def test_lane_layout(model, v):
    """S lanes a texel (a power of two dividing 32, the fewest that leave a
    lane at most ``VIEWS_PER_LANE_BY_ANGLES[A]`` views, else 32), VPL = ⌈V/S⌉
    within the lane's state budget, 128 / S texels a block; at V=16 (2, 8)
    for the two-channel lobes and (4, 4) for the three-channel ones; the
    largest view count is 32 lanes of the budget, and one more raises."""
    a_count = _angles(model)
    v_max = k1.max_views(a_count)
    assert v_max == 32 * (k1.LANE_STATE_FLOATS // (a_count + 5)) >= OLD_MAX_VIEWS[a_count]
    if v == "past":
        with pytest.raises(ValueError, match="registers"):
            k1.lane_layout(a_count, v_max + 1)
        return
    v = v_max if v == "largest" else v
    lanes, vpl, block_t = k1.lane_layout(a_count, v)
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes * block_t == k1.THREADS
    assert vpl == -(-v // lanes) and (vpl - 1) * lanes < v <= vpl * lanes
    assert vpl * (a_count + 5) <= k1.LANE_STATE_FLOATS
    per_lane = k1.VIEWS_PER_LANE_BY_ANGLES[a_count]
    assert lanes == lanegroup.group_lanes(v, per_lane)
    assert lanes == 1 or -(-v // (lanes // 2)) > per_lane      # no fewer lanes would do
    if v == 16:
        assert (lanes, vpl) == ((2, 8) if a_count == 2 else (4, 4))
    if v == v_max:
        assert lanes == 32


@pytest.mark.parametrize("a_count", [2, 3])
def test_every_view_count_the_first_k1_took_has_a_layout(a_count):
    """V = 1 … 259 (two angle channels) and 1 … 227 (three) each get a
    layout within the budget; ``lane_layout`` reads no texel count, so a
    texel's layout, and its sum order, do not depend on its batch."""
    for v in range(1, OLD_MAX_VIEWS[a_count] + 1):
        lanes, vpl, _ = k1.lane_layout(a_count, v)
        assert vpl * (a_count + 5) <= k1.LANE_STATE_FLOATS and lanes * vpl >= v
    with pytest.raises(ValueError):
        k1.lane_layout(a_count, 0)


def test_views_per_lane_is_the_kernels_twin():
    """``VIEWS_PER_LANE_BY_ANGLES`` picks the layouts and ``csrc/varpro.cu``'s
    ``kViewsPerLane`` gives those instantiations 20 warps an SM: the two
    tables hold the same numbers."""
    src = (pathlib.Path(k1.__file__).parent.parent / "csrc" / "varpro.cu").read_text()
    found = re.search(r"constexpr int kViewsPerLane\[(\d+)\] = \{([^}]*)\};", src)
    assert found is not None
    table = [int(x) for x in found.group(2).split(",")]
    assert len(table) == int(found.group(1))
    assert {a: n for a, n in enumerate(table) if n} == k1.VIEWS_PER_LANE_BY_ANGLES


def _tree_sum_np(x, lanes, vpl):
    """Per-lane float32 partials, left to right from 0 over views l, l + S,
    …, then the pairwise tree over the lanes, written out in numpy."""
    parts = []
    for lane in range(lanes):
        acc = np.zeros(x.shape[1:], np.float32)
        for k in range(vpl):
            if k * lanes + lane < x.shape[0]:
                acc = (acc + x[k * lanes + lane]).astype(np.float32)
        parts.append(acc)
    while len(parts) > 1:
        parts = [(parts[i] + parts[i + 1]).astype(np.float32) for i in range(0, len(parts), 2)]
    return parts[0][None]


def _problem(model, seed, v=V_RAGGED, dtype=np.float32, noise=0.0):
    """(V, T) inputs of K1 from known parameters, targets moved by ``noise``
    (relative), and a σ start 20% off the truth."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, T_RAGGED, v, dtype=dtype)
    true_p = true_params(model, rng, T_RAGGED, dtype)
    ta = convert.from_numpy(JAngles(**cols))
    with torch.no_grad():
        y = MODELS[model].fn(torch.tensor(true_p), ta)
    y = y * (1.0 + noise * torch.tensor(rng.standard_normal(y.shape), dtype=y.dtype))
    p0 = torch.tensor(true_p * rng.uniform(0.8, 1.2, true_p.shape).astype(dtype))
    return ta, y, p0


def test_plain_group_sum_is_the_kernels_tree_and_sums_every_view_quantity(monkeypatch):
    """``group_sum`` equals the numpy tree bit for bit at every layout
    ``lane_layout`` picks for V ∈ {1, 5, 16, 37, 100, 288}, and differs from
    a left-to-right sum somewhere; ``varpro_rows_plain`` sums every view
    quantity with it at ``lane_layout``'s layout: Σ a·a and Σ a·y, then per
    evaluation six sums of the lobe pass and two of the residual pass."""
    rng = np.random.default_rng(50)
    differs = False
    for v in (1, 5, 16, 37, 100, 288):
        lanes, vpl, _ = k1.lane_layout(2, v)
        x = (rng.standard_normal((v, 64)) * np.exp(rng.uniform(-8, 8, (v, 64)))).astype(np.float32)
        got = lanegroup.group_sum(torch.tensor(x), lanes, vpl).numpy()
        np.testing.assert_array_equal(got, _tree_sum_np(x, lanes, vpl))
        differs |= bool((got != _tree_sum_np(x, 1, v)).any())
    assert differs
    seen = []

    def spy(x, lanes, vpl):
        seen.append((x.shape[0], lanes, vpl))
        return lanegroup.group_sum(x, lanes, vpl)

    monkeypatch.setattr(k1, "group_sum", spy)
    ta, y, p0 = _problem("cook_torrance", seed=51)
    k1.varpro_fit_fused("cook_torrance", ta, y, p0=p0, iters=1)
    assert len(seen) == 2 + 2 * (6 + 2)
    assert set(seen) == {(V_RAGGED, *k1.lane_layout(3, V_RAGGED)[:2])}


@pytest.mark.parametrize("lanes", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("model", SEPARABLE)
def test_plain_k1_group_order_matches_left_to_right_float64(model, lanes, monkeypatch):
    """In float64, on noisy targets at V=37 and T=45, the grid init and the
    closed form at a start (no Newton step: a step divides by the projected
    curvature, which cancels), summed in the order of S lanes a texel, agree
    with the same solves summed left to right (one lane holding every view)
    within 1e-12 on every lane and every output row."""
    ta, y, p0 = _problem(model, seed=60 + SEPARABLE.index(model), dtype=np.float64, noise=0.01)
    cfg = k1.config(model)
    names = SHADING_KERNELS[model].angle_names
    ang = torch.stack([getattr(ta, n).T for n in names]).contiguous()   # float64, (A, V, T)
    yt, w = y.T.contiguous(), torch.ones_like(y.T).contiguous()
    for sig0 in (None, p0[:, 2].contiguous()):
        monkeypatch.setattr(k1, "lane_layout",
                            lambda a, v: (lanes, -(-v // lanes), k1.THREADS // lanes))
        grouped = k1.varpro_rows_plain(cfg, ang, yt, w, sig0, 0).numpy()
        monkeypatch.setattr(k1, "lane_layout", lambda a, v: (1, v, k1.THREADS))
        serial = k1.varpro_rows_plain(cfg, ang, yt, w, sig0, 0).numpy()
        assert grouped.dtype == np.float64
        np.testing.assert_allclose(grouped, serial, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model", SEPARABLE)
def test_zero_weight_views_change_nothing_where_a_lanes_last_slot_is_past_v(model):
    """At V=37 (the layout leaves the last slot of some lanes past V) views
    under zero weight, the last one among them, may hold any target: the fit
    is the same bit for bit, from the grid and from a start."""
    lanes, vpl, _ = k1.lane_layout(_angles(model), V_RAGGED)
    assert lanes * vpl > V_RAGGED
    ta, y, p0 = _problem(model, seed=70)
    w = torch.ones_like(y)
    masked = [0, 9, 20, V_RAGGED - 2, V_RAGGED - 1]
    w[:, masked] = 0.0
    bad = y.clone()
    bad[:, masked] = 9.0
    for start in (None, p0):
        r1 = k1.varpro_fit_fused(model, ta, y, weights=w, p0=start, iters=4)
        r2 = k1.varpro_fit_fused(model, ta, bad, weights=w, p0=start, iters=4)
        assert torch.isfinite(r1.p).all()
        torch.testing.assert_close(r1.p, r2.p, rtol=0, atol=0)
        torch.testing.assert_close(r1.chi2, r2.chi2, rtol=0, atol=0)


@pytest.mark.parametrize("model", SEPARABLE)
def test_plain_k1_takes_views_past_the_kernels_largest(model, monkeypatch):
    """Past ``max_views`` the register layout raises (the kernel runs its
    long-view path there), and the plain version, the CPU path of
    ``engine="varpro"``, takes any view count as the Pallas kernel does: it
    sums as 32 lanes of ⌈V/32⌉ views, which in float64 agrees with
    a left-to-right sum within 1e-12 (grid init and a start's closed form;
    the cancelling gradient within 1e-10 absolute), and in float32 its closed form at a start matches ``varpro_fit_pallas``
    lane for lane to 1e-4 on all but the near-singular lanes."""
    a_count = _angles(model)
    v = k1.max_views(a_count) + 5
    with pytest.raises(ValueError, match="registers"):
        k1.lane_layout(a_count, v)
    ta, y, p0 = _problem(model, seed=80 + SEPARABLE.index(model), v=v, dtype=np.float64,
                         noise=0.01)
    cfg = k1.config(model)
    names = SHADING_KERNELS[model].angle_names
    ang = torch.stack([getattr(ta, n).T for n in names]).contiguous()
    yt, w = y.T.contiguous(), torch.ones_like(y.T).contiguous()
    for sig0 in (None, p0[:, 2].contiguous()):
        grouped = k1.varpro_rows_plain(cfg, ang, yt, w, sig0, 0).numpy()
        with monkeypatch.context() as m:
            m.setattr(k1, "max_views", lambda a: 10**9)
            m.setattr(k1, "lane_layout", lambda a, n: (1, n, k1.THREADS))
            serial = k1.varpro_rows_plain(cfg, ang, yt, w, sig0, 0).numpy()
        assert np.isfinite(grouped).all()
        # |g| (row 6) is a sum of V terms r·∂b that cancels at the optimum
        keep = [0, 1, 2, 3, 4, 5, 7]
        np.testing.assert_allclose(grouped[keep], serial[keep], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(grouped[6], serial[6], rtol=1e-12, atol=1e-10)

    rng = np.random.default_rng(90 + SEPARABLE.index(model))
    cols = angle_columns(rng, 128, v)
    p = true_params(model, rng, 128)
    p0 = (p * rng.uniform(0.8, 1.2, p.shape)).astype(np.float32)
    with torch.no_grad():
        yf = MODELS[model].fn(torch.tensor(p), convert.from_numpy(JAngles(**cols))).numpy()
    rt = k1.varpro_fit_fused(model, convert.from_numpy(JAngles(**cols)), torch.tensor(yf),
                             p0=torch.tensor(p0), iters=0)
    rj = varpro_fit_pallas(model, JAngles(**cols), jnp.asarray(yf), p0=jnp.asarray(p0),
                           iters=0, block_t=128, interpret=True)
    assert agreement(rt.p.numpy(), np.asarray(rj.p), 1e-4) >= 0.97
