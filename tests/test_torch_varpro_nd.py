"""Kernel K8's plain version (brdf_tpu_torch/ops/varpro_nd.py) against the
Pallas kernel it ports, ``varpro_fit_pallas_nd(..., interpret=True)``, in
float32 on the same inputs: the anisotropic lobes on the tangent-frame scene
of ``tests/test_varpro.py::_aniso_problem``, cook_torrance_fresnel on
``bench.py::make_problem``'s angles.

The closed form (a start and no Newton step) is held lane for lane. Past it
the float32 d-D solve is chaotic at one ulp, like K1's (ROADMAP.md Queue C):
XLA's and torch's transcendentals differ by an ulp on some arguments, and
after one Newton step the port moves as far from the Pallas kernel as from
itself under a one-ulp change of the angles and the targets. Those tests hold
the port to that spread, and the float64 test holds the plain version's
arithmetic to the JAX package's eager d-D tier lane for lane.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.models.brdf import shading_angles as j_shading_angles  # noqa: E402
from brdf_tpu.ops.varpro_pallas import varpro_fit_pallas_nd  # noqa: E402
from brdf_tpu.solver.init import default_shape_grid as j_default_shape_grid  # noqa: E402
from brdf_tpu.solver.varpro import _SEPARABLE_ND as J_SEPARABLE_ND, varpro_fit_nd  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.ops import varpro_nd as k8  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS  # noqa: E402
from torch_port_inputs import (  # noqa: E402
    agreement,
    angle_columns,
    aniso_geometry,
    aniso_recovery,
    recovery,
    true_params,
    ulp_bump,
)

T, V = 256, 16
LOBES = ("ward_aniso", "cook_torrance_aniso", "cook_torrance_fresnel")
# the timber-aniso preset's box (brdf_tpu/configs.py)
TIMBER_LOWER = (0.0, 0.0, 1e-3, 1e-3, -1.5707963)
TIMBER_UPPER = (2.0, 2.0, 1.0, 1.0, 1.5707963)


def _problem(model, seed, dtype=np.float32):
    """(angle columns, true parameters, targets, a start within 10%, rng)."""
    rng = np.random.default_rng(seed)
    if J_MODELS[model].tangent:
        pts, nrm, eye, lights = aniso_geometry(rng, T, V)
        ja = j_shading_angles(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(eye),
                              jnp.asarray(lights), tangent_frame=True)
        cols = {k: np.asarray(getattr(ja, k)).astype(dtype) for k in ja._fields
                if getattr(ja, k) is not None}
        true_p = np.stack([rng.uniform(0.1, 0.9, T), rng.uniform(0.3, 1.0, T),
                           rng.uniform(0.15, 0.9, T), rng.uniform(0.15, 0.9, T),
                           rng.uniform(-1.2, 1.2, T)], -1).astype(dtype)
    else:
        cols = angle_columns(rng, T, V, dtype=dtype)
        true_p = true_params(model, rng, T, dtype=dtype)
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), JAngles(**cols))).astype(dtype)
    p0 = (true_p * rng.uniform(0.9, 1.1, true_p.shape)).astype(dtype)
    return cols, true_p, y, p0, rng


def _port(model, cols, y, w=None, p0=None, iters=12, **kw):
    return k8.varpro_fit_fused_nd(
        model, convert.from_numpy(JAngles(**cols)), torch.tensor(y),
        weights=None if w is None else torch.tensor(w),
        p0=None if p0 is None else torch.tensor(p0), iters=iters, **kw)


def _pallas(model, cols, y, w=None, p0=None, iters=12, **kw):
    return varpro_fit_pallas_nd(
        model, JAngles(**cols), jnp.asarray(y), weights=None if w is None else jnp.asarray(w),
        p0=None if p0 is None else jnp.asarray(p0), iters=iters, block_t=128, interpret=True, **kw)


def _quality(model, p, true_p):
    return aniso_recovery(p, true_p) if J_MODELS[model].tangent else recovery(p, true_p)


@pytest.mark.parametrize("model", LOBES)
def test_plain_k8_closed_form_matches_pallas_lane_for_lane(model):
    """With a start and no Newton step the result is the closed-form linear
    pair at the clipped start: 1e-4 on ≥ 97% of the lanes."""
    cols, _, y, p0, _ = _problem(model, seed=LOBES.index(model))
    rj, rt = _pallas(model, cols, y, p0=p0, iters=0), _port(model, cols, y, p0=p0, iters=0)
    pt, pj = rt.p.numpy(), np.asarray(rj.p)
    assert pt.shape == (T, J_MODELS[model].n_params) and pt.dtype == np.float32
    assert agreement(pt, pj, 1e-4) >= 0.97
    np.testing.assert_array_equal(pt[:, 2:], pj[:, 2:])
    np.testing.assert_array_equal(rt.iters.numpy(), 0)


@pytest.mark.parametrize("iters", [1, 12])
@pytest.mark.parametrize("model", LOBES)
def test_plain_k8_newton_matches_pallas(model, iters):
    """From a start within 10% of the truth: one Newton step, and the full
    solve with ``tests/test_varpro.py:616-622``'s bars (median χ² < 1e-10, kd
    within 1e-3 on > 95% of lanes). Lane agreement is held to the port's own
    spread under a one-ulp change of angles and targets (0.06 ≈ four
    standard deviations of a share on 256 lanes)."""
    cols, _, y, p0, rng = _problem(model, seed=10 + LOBES.index(model))
    rj, rt = _pallas(model, cols, y, p0=p0, iters=iters), _port(model, cols, y, p0=p0, iters=iters)
    pt, pj = rt.p.numpy(), np.asarray(rj.p)
    cols_ulp = {k: ulp_bump(rng, x) for k, x in cols.items()}
    pu = _port(model, cols_ulp, ulp_bump(rng, y), p0=p0, iters=iters).p.numpy()
    for rtol in (1e-4, 1e-2):
        assert agreement(pt, pj, rtol) >= agreement(pu, pt, rtol) - 0.06
    close = np.isclose(pt, pj, rtol=1e-3, atol=1e-3).all(-1).mean()
    close_ulp = np.isclose(pu, pt, rtol=1e-3, atol=1e-3).all(-1).mean()
    assert close >= close_ulp - 0.06
    if iters == 12:
        assert float(np.median(rt.chi2.numpy())) < 1e-10
        assert float(np.median(np.asarray(rj.chi2))) < 1e-10
        assert np.isclose(pt[:, 0], pj[:, 0], rtol=1e-3, atol=1e-3).mean() > 0.95


@pytest.mark.parametrize("model", LOBES)
def test_plain_k8_grid_init_matches_pallas(model):
    """The in-kernel grid of d-tuples, then 12 steps: median χ² < 1e-10 in
    both, recovery (canonicalised for the anisotropic lobes) within 0.03."""
    cols, true_p, y, _, _ = _problem(model, seed=20 + LOBES.index(model))
    rj, rt = _pallas(model, cols, y), _port(model, cols, y)
    assert float(np.median(rt.chi2.numpy())) < 1e-10
    assert float(np.median(np.asarray(rj.chi2))) < 1e-10
    assert abs(_quality(model, rt.p.numpy(), true_p) - _quality(model, np.asarray(rj.p), true_p)) <= 0.03
    np.testing.assert_array_equal(np.isin(rt.stop.numpy(), (2, 3)), True)
    if J_MODELS[model].tangent:
        # the signed φ keeps its box (the JAX package's r5 floor regression)
        p = rt.p.numpy()
        assert p[:, 4].min() < -0.1 and p[:, 4].max() > 0.1
        assert p[:, 2].min() >= 1e-3 and p[:, 3].min() >= 1e-3


@pytest.mark.parametrize("model", LOBES)
def test_zero_weight_views_change_nothing(model):
    """Poisoned views under zero weight leave the fit bit for bit alone."""
    cols, _, y, _, _ = _problem(model, seed=30)
    w = np.ones_like(y)
    w[:, 12:] = 0.0
    bad = y.copy()
    bad[:, 12:] = 9.0
    r1, r2 = _port(model, cols, y, w=w, iters=4), _port(model, cols, bad, w=w, iters=4)
    np.testing.assert_array_equal(r1.p.numpy(), r2.p.numpy())
    np.testing.assert_array_equal(r1.chi2.numpy(), r2.chi2.numpy())


@pytest.mark.parametrize("model,box", [(m, "default") for m in LOBES]
                         + [(m, "timber-aniso") for m in LOBES[:2]])
def test_config_matches_pallas_grid_and_box(model, box):
    """The grid of d-tuples and the boxes K8 receives are
    ``varpro_fit_pallas_nd``'s: ``default_shape_grid`` clipped to the floored
    shape box, the signed φ not floored."""
    lower, upper = (TIMBER_LOWER, TIMBER_UPPER) if box == "timber-aniso" else (None, None)
    cfg = k8.config(model, lower, upper)
    spec = J_MODELS[model]
    d = spec.n_params - 2
    lo = lower or tuple(float(x) for x in spec.lower)
    hi = upper or tuple(float(x) for x in spec.upper)
    lo_s = tuple(max(lo[2 + j], J_SEPARABLE_ND[model][j]) for j in range(d))
    hi_s = tuple(hi[2 + j] for j in range(d))
    grid = np.clip(np.asarray(j_default_shape_grid(model, num=8), np.float64).reshape(-1, d),
                   lo_s, hi_s)
    assert cfg.d == d and cfg.lo_s == lo_s and cfg.hi_s == hi_s
    assert cfg.grid == tuple(tuple(float(np.float32(x)) for x in row) for row in grid)
    assert cfg.box == (lo[0], hi[0], lo[1], hi[1])
    assert cfg.span == pytest.approx(float(np.linalg.norm(np.subtract(hi_s, lo_s))), rel=1e-15)
    if spec.tangent:
        assert cfg.lo_s[2] == lo[4] < 0 and len(cfg.grid) == 18
    assert len(k8.config(model, lower, upper, grid_points=16).grid) in (16, 32)


@pytest.mark.parametrize("model", ["ward_aniso", "cook_torrance_aniso"])
def test_plain_k8_float64_matches_eager_jax_tier(model):
    """In float64 most of float32's chaos is gone: from one start, the plain
    version (one analytic evaluation a step) and the JAX package's eager
    ``varpro_fit_nd`` (a JVP per shape dimension) agree within 1e-4 on ≥ 99%
    of lanes after one step and after eight, and within 1e-6 on ≥ 97%: the
    analytic partials and the JVP differ in the last bits, which an
    ill-conditioned projected curvature scales up on a few lanes."""
    cols, true_p, _, p0, _ = _problem(model, seed=40, dtype=np.float64)
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), JAngles(**cols)))
    names = SHADING_KERNELS[model].angle_names
    ang = torch.stack([torch.tensor(cols[n]).T for n in names]).contiguous()
    yt = torch.tensor(y).T.contiguous()
    cfg = k8.config(model)
    for iters in (1, 8):
        out = k8.varpro_nd_rows_plain(cfg, ang, yt, torch.ones_like(yt), torch.tensor(p0).T, iters)
        assert out.dtype == torch.float64
        rj = varpro_fit_nd(model, JAngles(**cols), jnp.asarray(y), p0=jnp.asarray(p0), iters=iters)
        pt, pj = out[:5].T.numpy(), np.asarray(rj.p)
        assert agreement(pt, pj, 1e-4) >= 0.99
        assert agreement(pt, pj, 1e-6) >= 0.97


# the largest V the first, shared-memory K8 took (32 texels a block)
OLD_MAX_VIEWS = {"cook_torrance_aniso": 113, "ward_aniso": 151, "cook_torrance_fresnel": 181}


@pytest.mark.parametrize("v", [1, 2, 16, 37, "largest", "past"])
@pytest.mark.parametrize("model", LOBES)
def test_lane_layout(model, v):
    """S lanes a texel (a power of two dividing 32), VPL = ⌈V/S⌉ views a lane
    within the lane's state budget, a block of 128 threads; every view count
    the first K8 took still has a layout, and one past the largest raises."""
    a_count = len(SHADING_KERNELS[model].angle_names)
    d = J_MODELS[model].n_params - 2
    v_max = k8.max_views(a_count, d)
    assert v_max >= OLD_MAX_VIEWS[model]
    if v == "past":
        with pytest.raises(ValueError, match="registers"):
            k8.lane_layout(a_count, d, v_max + 1)
        return
    v = v_max if v == "largest" else v
    lanes, vpl, block_t = k8.lane_layout(a_count, d, v)
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes * block_t == k8.THREADS
    assert vpl == -(-v // lanes) and (vpl - 1) * lanes < v <= vpl * lanes
    assert vpl * (a_count + 4 + d) <= k8.LANE_STATE_FLOATS


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


def test_plain_group_sum_is_a_pairwise_tree_of_lane_partials(monkeypatch):
    """``group_sum`` equals the numpy tree bit for bit on every layout
    ``lane_layout`` picks for V ∈ {1, 2, 3, 16, 37, 128}, and differs from a
    left-to-right sum somewhere; ``varpro_nd_rows_plain`` sums every view
    quantity with it at ``lane_layout``'s layout."""
    rng = np.random.default_rng(60)
    differs = False
    for v in (1, 2, 3, 16, 37, 128):
        lanes, vpl, _ = k8.lane_layout(9, 3, v)
        x = (rng.standard_normal((v, 64)) * np.exp(rng.uniform(-8, 8, (v, 64)))).astype(np.float32)
        got = k8.group_sum(torch.tensor(x), lanes, vpl).numpy()
        np.testing.assert_array_equal(got, _tree_sum_np(x, lanes, vpl))
        differs |= bool((got != _tree_sum_np(x, 1, v)).any())
    assert differs
    seen = []
    real = k8.group_sum

    def spy(x, lanes, vpl):
        seen.append((x.shape[0], lanes, vpl))
        return real(x, lanes, vpl)

    monkeypatch.setattr(k8, "group_sum", spy)
    cols, _, y, p0, _ = _problem("ward_aniso", seed=61)
    _port("ward_aniso", cols, y, p0=p0, iters=1)
    assert len(seen) == 2 + 2 * (3 + 1 + 3 * 3 + 6)
    assert set(seen) == {(V, *k8.lane_layout(5, 3, V)[:2])}


@pytest.mark.parametrize("model", LOBES)
def test_plain_k8_group_order_matches_left_to_right_float64(model, monkeypatch):
    """In float64 the closed-form solve (a start, no Newton step) in the lane
    order agrees with the same solve summed left to right (one lane holding
    every view) within 1e-12 on every lane and every output row."""
    cols, _, y, p0, rng = _problem(model, seed=70 + LOBES.index(model), dtype=np.float64)
    y = y * (1.0 + 0.01 * rng.standard_normal(y.shape))
    names = SHADING_KERNELS[model].angle_names
    ang = torch.stack([torch.tensor(cols[n]).T for n in names]).contiguous()
    yt = torch.tensor(y).T.contiguous()
    w = torch.ones_like(yt)
    cfg = k8.config(model)
    p0t = torch.tensor(p0.astype(np.float64)).T.contiguous()
    lanes, _, _ = k8.lane_layout(len(names), cfg.d, V)
    assert lanes > 1
    grouped = k8.varpro_nd_rows_plain(cfg, ang, yt, w, p0t, 0).numpy()
    monkeypatch.setattr(k8, "lane_layout", lambda a, d, v: (1, v, k8.THREADS))
    serial = k8.varpro_nd_rows_plain(cfg, ang, yt, w, p0t, 0).numpy()
    assert grouped.dtype == np.float64
    np.testing.assert_allclose(grouped, serial, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    """On CPU tensors the wrapper runs the plain version (no launch is
    counted); the kernel's launcher refuses CPU tensors instead of falling
    back; lobes and grids the kernel does not take raise."""
    model = "ward_aniso"
    cols, _, y, p0, _ = _problem(model, seed=50)
    before = k8.LAUNCHES
    r = _port(model, cols, y, p0=p0, iters=2)
    assert r.p.shape == (T, 5) and k8.LAUNCHES == before
    cfg = k8.config(model)
    inputs = k8.stack_inputs(model, convert.from_numpy(JAngles(**cols)), torch.tensor(y),
                             p0=torch.tensor(p0))
    assert inputs[0].shape == (5, V, T) and inputs[3].shape == (5, T)
    with pytest.raises(ValueError, match="CUDA"):
        k8.varpro_nd_rows_cuda(cfg, *inputs, 2)
    with pytest.raises(ValueError, match="supports"):
        k8.config("cook_torrance")
    with pytest.raises(ValueError, match="at most 32 grid points"):
        k8.config(model, grid_points=20)
