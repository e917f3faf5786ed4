"""K1 and K8 past their register layouts, on the CPU: the long-view layout
(``ops/lanegroup.py::long_view_layout``) and the plain versions' sums in its
order.

The Pallas VarPro kernels take any view count that fits VMEM. K1 and K8 hold a
texel's views in registers up to ``max_views`` (a lane group of at most 32
lanes); past it each runs its long-view path, 32 lanes a texel that read their
views from device memory in every pass. The plain versions sum in that path's
order, so that ``engine="varpro"`` on CPU tensors takes every view count, and
the card can hold kernel and plain version to equality. Here the plain K8 is
held to ``varpro_fit_pallas_nd(interpret=True)`` in its closed form at a start
(the bar of ``tests/test_torch_varpro_nd.py``), and the long-view order to a
left-to-right sum in float64.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.models.brdf import shading_angles as j_shading_angles  # noqa: E402
from brdf_tpu.ops.varpro_pallas import varpro_fit_pallas_nd  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.ops import lanegroup, varpro as k1, varpro_nd as k8  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS  # noqa: E402
from brdf_tpu_torch.parallel.fit import fit_texels  # noqa: E402
from torch_port_inputs import agreement, angle_columns, aniso_geometry, true_params  # noqa: E402

T = 128
LONG = 400
ANISO = ("ward_aniso", "cook_torrance_aniso")


def _k8_max(model):
    return k8.max_views(len(SHADING_KERNELS[model].angle_names), J_MODELS[model].n_params - 2)


def _views(model, v):
    return _k8_max(model) + 5 if v == "past" else v


def _aniso_problem(model, v, seed, dtype=np.float32):
    """(angle columns, targets, a start within 10% of the truth, rng) on the
    tangent-frame scene of ``tests/test_varpro.py::_aniso_problem``."""
    rng = np.random.default_rng(seed)
    pts, nrm, eye, lights = aniso_geometry(rng, T, v)
    ja = j_shading_angles(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(eye),
                          jnp.asarray(lights), tangent_frame=True)
    cols = {k: np.asarray(getattr(ja, k)).astype(dtype) for k in ja._fields
            if getattr(ja, k) is not None}
    true_p = true_params(model, rng, T, dtype=dtype)
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(true_p), JAngles(**cols))).astype(dtype)
    p0 = (true_p * rng.uniform(0.9, 1.1, true_p.shape)).astype(dtype)
    return cols, y, p0, rng


@pytest.mark.parametrize("v", ["past", LONG])
@pytest.mark.parametrize("model", ANISO)
def test_fit_texels_varpro_takes_views_past_the_register_layout(model, v):
    """``fit_texels(engine="varpro", device="cpu")`` fits every view count:
    finite (T, 5) parameters and χ² past K8's register layout."""
    v = _views(model, v)
    with pytest.raises(ValueError, match="registers"):
        k8.lane_layout(len(SHADING_KERNELS[model].angle_names), J_MODELS[model].n_params - 2, v)
    cols, y, _, _ = _aniso_problem(model, v, seed=10 + ANISO.index(model))
    res = fit_texels(model, convert.from_numpy(JAngles(**cols)), torch.tensor(y),
                     engine="varpro", device="cpu")
    assert res.p.shape == (T, 5)
    assert torch.isfinite(res.p).all() and torch.isfinite(res.chi2).all()


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance"])
def test_fit_texels_varpro_takes_long_views_for_k1(model):
    """The same for the m=3 lobes, through K1's plain version at 400 views."""
    rng = np.random.default_rng(20)
    cols = angle_columns(rng, T, LONG)
    y = np.asarray(J_MODELS[model].fn(jnp.asarray(true_params(model, rng, T)), JAngles(**cols)))
    res = fit_texels(model, convert.from_numpy(JAngles(**cols)), torch.tensor(y),
                     engine="varpro", device="cpu")
    assert res.p.shape == (T, 3) and torch.isfinite(res.p).all()


@pytest.mark.parametrize("v", ["past", LONG])
@pytest.mark.parametrize("model", ANISO)
def test_plain_k8_closed_form_at_long_views_matches_pallas(model, v):
    """With a start and no Newton step, the plain K8 summed in the long-view
    order matches ``varpro_fit_pallas_nd(interpret=True)`` to 1e-4 on ≥ 97%
    of the lanes, and takes the clipped start's shape as it is."""
    v = _views(model, v)
    cols, y, p0, _ = _aniso_problem(model, v, seed=30 + ANISO.index(model))
    rt = k8.varpro_fit_fused_nd(model, convert.from_numpy(JAngles(**cols)), torch.tensor(y),
                                p0=torch.tensor(p0), iters=0)
    rj = varpro_fit_pallas_nd(model, JAngles(**cols), jnp.asarray(y), p0=jnp.asarray(p0),
                              iters=0, block_t=128, interpret=True)
    pt, pj = rt.p.numpy(), np.asarray(rj.p)
    assert pt.shape == (T, 5) and np.isfinite(pt).all()
    assert agreement(pt, pj, 1e-4) >= 0.97
    np.testing.assert_array_equal(pt[:, 2:], pj[:, 2:])


@pytest.mark.parametrize("v", ["past", LONG])
@pytest.mark.parametrize("model", ANISO)
def test_plain_k8_long_view_order_matches_left_to_right_float64(model, v, monkeypatch):
    """In float64, on noisy targets, the closed form at a start summed in the
    long-view order (32 lanes of ⌈V/32⌉ views) agrees with the same solve
    summed left to right within 1e-12 on every lane and output row (max |g|,
    a sum that cancels near the optimum, within 1e-10 absolute). The grid
    init is left out, as in ``tests/test_torch_varpro_nd.py``: the
    anisotropic grid holds mirror tuples, (ax, ay, φ) and (ay, ax, φ + π/2),
    whose costs tie exactly, and any sum order may pick the other one."""
    v = _views(model, v)
    cols, y, p0, rng = _aniso_problem(model, v, seed=40 + ANISO.index(model), dtype=np.float64)
    y = y * (1.0 + 0.01 * rng.standard_normal(y.shape))
    names = SHADING_KERNELS[model].angle_names
    ang = torch.stack([torch.tensor(cols[n]).T for n in names]).contiguous()
    yt = torch.tensor(y).T.contiguous()
    w = torch.ones_like(yt)
    cfg = k8.config(model)
    assert k8.kernel_layout(len(names), cfg.d, v) == (32, -(-v // 32), k8.THREADS // 32)
    g_row = 5 + cfg.d
    keep = [r for r in range(16) if r != g_row]
    start = torch.tensor(p0).T.contiguous()
    grouped = k8.varpro_nd_rows_plain(cfg, ang, yt, w, start, 0).numpy()
    monkeypatch.setattr(k8, "kernel_layout", lambda a, d, n: (1, n, k8.THREADS))
    serial = k8.varpro_nd_rows_plain(cfg, ang, yt, w, start, 0).numpy()
    assert grouped.dtype == np.float64 and np.isfinite(grouped).all()
    np.testing.assert_allclose(grouped[keep], serial[keep], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(grouped[g_row], serial[g_row], rtol=1e-12, atol=1e-10)


def _k1_angles(model):
    return len(SHADING_KERNELS[model].angle_names)


@pytest.mark.parametrize("kernel", ["K1/blinn_phong", "K1/cook_torrance", "K8/cook_torrance_fresnel",
                                    "K8/ward_aniso", "K8/cook_torrance_aniso"])
def test_kernel_layout_switches_to_the_long_view_path_past_the_registers(kernel):
    """Up to ``max_views`` the kernel runs ``lane_layout``'s register layout;
    one view more and it runs the long-view layout, 32 lanes a texel holding
    ⌈V/32⌉ views each, 4 texels a block of 128 threads, read from V alone."""
    which, model = kernel.split("/")
    a_count = len(SHADING_KERNELS[model].angle_names)
    if which == "K1":
        v_max = k1.max_views(a_count)
        layout = lambda v: k1.kernel_layout(a_count, v)  # noqa: E731
        regs = lambda v: k1.lane_layout(a_count, v)  # noqa: E731
    else:
        d = J_MODELS[model].n_params - 2
        v_max = k8.max_views(a_count, d)
        layout = lambda v: k8.kernel_layout(a_count, d, v)  # noqa: E731
        regs = lambda v: k8.lane_layout(a_count, d, v)  # noqa: E731
    assert layout(v_max) == regs(v_max)
    for v in (v_max + 1, LONG, 1000, 2**20 + 3):
        lanes, vpl, block_t = layout(v)
        assert (lanes, block_t) == (32, 4) and (vpl - 1) * 32 < v <= vpl * 32
        assert (lanes, vpl, block_t) == lanegroup.long_view_layout(v, 128)
        with pytest.raises(ValueError, match="registers"):
            regs(v)
    with pytest.raises(ValueError):
        lanegroup.long_view_layout(0, 128)


def test_long_view_group_sum_repeats_32_lane_partials_and_the_tree():
    """``group_sum`` in the long-view layout: each of 32 lanes adds views
    l, l + 32, … left to right from 0 in float32, then the pairwise tree."""
    rng = np.random.default_rng(5)
    v = 293
    x = rng.standard_normal((v, 7)).astype(np.float32)
    lanes, vpl, _ = lanegroup.long_view_layout(v, 128)
    parts = []
    for lane in range(lanes):
        acc = np.zeros(7, np.float32)
        for k in range(vpl):
            if k * lanes + lane < v:
                acc = (acc + x[k * lanes + lane]).astype(np.float32)
        parts.append(acc)
    while len(parts) > 1:
        parts = [(parts[i] + parts[i + 1]).astype(np.float32) for i in range(0, len(parts), 2)]
    got = lanegroup.group_sum(torch.tensor(x), lanes, vpl)[0].numpy()
    np.testing.assert_array_equal(got, parts[0])


@pytest.mark.parametrize("kernel", ["K1", "K8"])
def test_cuda_wrappers_refuse_cpu_tensors_at_long_views(kernel):
    """At a long view count the CUDA wrappers take no CPU tensor: there is
    no fallback to the plain version behind them."""
    rng = np.random.default_rng(6)
    if kernel == "K1":
        cols = angle_columns(rng, 8, LONG)
        y = torch.tensor(rng.uniform(size=(8, LONG)).astype(np.float32))
        inputs = k1.stack_inputs("cook_torrance", convert.from_numpy(JAngles(**cols)), y)
        with pytest.raises(ValueError, match="CUDA"):
            k1.varpro_rows_cuda(k1.config("cook_torrance"), *inputs, 2)
    else:
        cols = angle_columns(rng, 8, LONG, tangent=True)
        y = torch.tensor(rng.uniform(size=(8, LONG)).astype(np.float32))
        inputs = k8.stack_inputs("ward_aniso", convert.from_numpy(JAngles(**cols)), y)
        with pytest.raises(ValueError, match="CUDA"):
            k8.varpro_nd_rows_cuda(k8.config("ward_aniso"), *inputs, 2)
