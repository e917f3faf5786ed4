"""K6's and K7's split of a texel's views (brdf_tpu_torch/ops/ne.py::ne_layout)
and the plain versions' sums in that split's order
(ops/lanegroup.py::group_sum), on the CPU.

On the card K6 and K7 split a texel's views over the W warps of a block,
each adding its views left to right from 0, and combine the W partials as a
pairwise tree; K7 adds a view's three channel terms in channel order. The plain versions repeat that order, so
that the two agree bit for bit there. Here the order is held to an explicit
loop, to left-to-right sums in float64, and, at the layout the function
picks, to the JAX package's Pallas kernels in interpret mode at the bars of
tests/test_torch_ne.py and tests/test_torch_joint_ne.py; and the CUDA
wrapper is shown to launch the layout the plain version sums in."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.ops.lm_pallas import _joint_ne_call, _joint_prep as j_joint_prep  # noqa: E402
from brdf_tpu_torch.ops import _build, lanegroup, lm as k5, ne  # noqa: E402
from brdf_tpu_torch.ops.shading import SHADING_KERNELS  # noqa: E402
from test_torch_joint_ne import _case as _joint_case, _port_rows as _joint_port_rows  # noqa: E402
from test_torch_joint_ne import _stacks64  # noqa: E402
from test_torch_ne import _assert_rows, _case, _jax_rows, _port_rows  # noqa: E402

MODES = ("chi2", "grad", "full")
# every split the kernels take, one thread a texel first
LAYOUTS = (1, 2, 4, 8)
# a view count past what K5 stages for the three-channel lobes (363)
V_PAST_K5 = 384


def _explicit(terms, n):
    """The order written out: partial p adds views p, p + n, … left to right
    from 0, each view's terms in list order; then the pairwise tree."""
    v = terms[0].shape[0]
    parts = []
    for p in range(n):
        acc = torch.zeros_like(terms[0][0])
        for view in range(p, v, n):
            for x in terms:
                acc = acc + x[view]
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


@pytest.mark.parametrize("v", [1, 3, 16, 37, 384])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_group_sum_of_term_lists_is_the_explicit_order(n, v):
    """Bit for bit in float32, one term and three (K7's channels)."""
    rng = np.random.default_rng(n * 1000 + v)
    terms = [torch.tensor(rng.standard_normal((v, 7)).astype(np.float32) * 10.0 ** rng.integers(-3, 4))
             for _ in range(3)]
    vpl = -(-v // n)
    for xs in (terms[:1], terms):
        got = lanegroup.group_sum(xs, n, vpl)
        assert got.shape == (1, 7)
        assert torch.equal(got[0], _explicit(xs, n))
    assert torch.equal(lanegroup.group_sum(terms[0], n, vpl), lanegroup.group_sum(terms[:1], n, vpl))


@contextlib.contextmanager
def _forced(warps):
    saved = ne.ne_layout
    ne.ne_layout = lambda *a: warps
    try:
        yield
    finally:
        ne.ne_layout = saved


def _rel_close(got, ref):
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-300)
    assert ((got - ref).abs() <= 1e-12 * scale).all(), float(((got - ref).abs() / scale).max())


@pytest.mark.parametrize("layout", LAYOUTS[1:], ids=lambda x: f"W{x}")
@pytest.mark.parametrize("model", ["cook_torrance", "ward_aniso", "lambert"])
def test_k6_rows_in_every_layout_match_left_to_right_in_float64(model, layout):
    """χ², JᵀW²J and JᵀW²e of every mode and both weight variants, summed in
    the layout's order, within 1e-12 of each row's scale of the rows summed
    left to right (one thread a texel), in float64."""
    t, v = 21, 37
    _, ta, target, params, w = _case(model, t, v, 70, True)
    for mode in MODES:
        for weights in (w, None):
            with _forced(ne.ONE_THREAD):
                ref = _port_rows(model, mode, ta, target, params, weights, dtype=torch.float64)
            with _forced(layout):
                got = _port_rows(model, mode, ta, target, params, weights, dtype=torch.float64)
            assert got.dtype == torch.float64 and got.shape == ref.shape
            _rel_close(got, ref)


@pytest.mark.parametrize("layout", LAYOUTS[1:], ids=lambda x: f"W{x}")
@pytest.mark.parametrize("base", ["cook_torrance", "phong"])
def test_k7_rows_in_every_layout_match_left_to_right_in_float64(base, layout):
    """The 55 rows of the joint normal equations (and the χ² and gradient
    modes) in the layout's order within 1e-12 of left to right in float64;
    the 12 structural zeros stay exact zeros."""
    t, v = 19, 37
    _, tg, target, params, w = _joint_case(base, t, v, 71, True)
    lv, y, ww, frame = _stacks64(tg, target, w)
    p_rows = torch.tensor(params, dtype=torch.float64).T.contiguous()
    for mode in MODES:
        with _forced(ne.ONE_THREAD):
            ref = ne.joint_ne_rows(base, mode, lv, y, ww, p_rows, frame)
        with _forced(layout):
            got = ne.joint_ne_rows(base, mode, lv, y, ww, p_rows, frame)
        assert got.dtype == torch.float64 and got.shape == ref.shape
        _rel_close(got, ref)
        if mode == "full":
            assert int((got[1:46] == 0).all(1).sum()) == 12


@pytest.mark.parametrize("v", [16, V_PAST_K5])
@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "ward_aniso"])
def test_k6_plain_rows_at_the_chosen_layout_match_the_pallas_kernel(model, v):
    """At V=16 (one thread a texel) and past K5's staging (a warp split) the
    CPU rows, in the order the card would use, against ``_ne_call`` in
    interpret mode at tests/test_torch_ne.py's bars, weighted and not."""
    t = 9
    m = SHADING_KERNELS[model].n_params
    assert not k5.fits_fused(3, V_PAST_K5)
    for mode in MODES:
        assert ne.ne_layout("ne", m, mode, v) == (ne.ONE_THREAD if v == 16 else 8)
        for weighted in (True, False):
            cols, ta, target, params, w = _case(model, t, v, 80, weighted)
            got = _port_rows(model, mode, ta, target, params, w).numpy()
            _assert_rows(got, _jax_rows(model, mode, cols, target, params, w), m, mode)


@pytest.mark.parametrize("v", [16, V_PAST_K5])
@pytest.mark.parametrize("base", ["cook_torrance", "blinn_phong"])
def test_k7_plain_rows_at_the_chosen_layout_match_the_pallas_kernel(base, v):
    """The joint ``full`` rows in the order the card would use against
    ``_joint_ne_call`` in interpret mode, at tests/test_torch_joint_ne.py's
    bars (χ² rtol 5e-5; g rtol 2e-3, atol 2e-4; JᵀJ rtol 1e-3 with 1e-5 of
    the row's scale)."""
    t = 11
    assert ne.ne_layout("joint_ne", 9, "full", v) == (ne.ONE_THREAD if v == 16 else 4)
    jg, tg, target, params, w = _joint_case(base, t, v, 81, True)
    spec, lv, y, wj, geom_rows, _, _, _, pad_t, vb = j_joint_prep(
        base, jg, jnp.asarray(target), jnp.asarray(w), 128, v)
    p_rows = jnp.pad(jnp.asarray(params).T, ((0, 16 - 9), (0, pad_t)))
    ref = np.asarray(_joint_ne_call(spec, lv, y, wj, p_rows, geom_rows, 128, vb, "full", True))[:55, :t]
    got = _joint_port_rows(base, "full", tg, target, params, w).numpy()
    np.testing.assert_allclose(got[0], ref[0], rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(got[46:], ref[46:], rtol=2e-3, atol=2e-4)
    a_got, a_ref = got[1:46], ref[1:46]
    scale = np.abs(a_ref).max(axis=1, keepdims=True)
    off = np.abs(a_got - a_ref) - (1e-3 * np.abs(a_ref) + 1e-5 * scale + 1e-7)
    assert (off <= 0).all(), (off.max(), np.argwhere(off > 0)[:5])


class _FakeEntry:
    """Stands in for a kernel's ctypes entry: notes the split it was asked to
    launch and returns success."""

    def __init__(self):
        self.warps = []

    def __call__(self, lobe, mode, warps, *rest):
        self.warps.append(warps)
        return 0


@pytest.mark.parametrize("v, t", [(16, 1048576), (384, 65536), (16, 131072), (37, 517), (1, 9)])
def test_the_wrapper_launches_the_layout_the_plain_version_sums_in(monkeypatch, v, t):
    """With the device checks and the library stood in for, ``ne_rows_cuda``
    and ``joint_ne_rows_cuda`` launch the split that ``ne_layout`` gives the
    plain versions for the same kernel, m, mode and V (a spy on
    ``ne_layout`` sees the same arguments from both)."""
    seen = []
    real = ne.ne_layout

    def spy(*args):
        seen.append(args)
        return real(*args)

    entry = _FakeEntry()
    monkeypatch.setattr(ne, "LAUNCHES", {"ne": 0, "joint_ne": 0})
    monkeypatch.setattr(ne, "ne_layout", spy)
    monkeypatch.setattr(_build, "check_operands", lambda *a: None)
    monkeypatch.setattr(_build, "lookup", lambda e: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    model, m = "cook_torrance", 3
    empty = torch.empty(1)
    for mode in MODES:
        ang = empty.expand(3, v, t)
        y = empty.expand(v, t)
        launched = ne.ne_rows_cuda(model, mode, ang, y, y, empty.expand(m, t))
        assert launched.shape == (ne.ne_rows_count(m, mode), t)
        lv, y3, frame = empty.expand(6, v, t), empty.expand(3, v, t), empty.expand(9, t)
        ne.joint_ne_rows_cuda(model, mode, lv, y3, y3, frame, frame)
    asked = [(kernel, mm, mode, v) for mode in MODES for kernel, mm in (("ne", m), ("joint_ne", 9))]
    assert seen == asked
    assert entry.warps == [real(*args) for args in asked]
    assert ne.LAUNCHES == {"ne": 3, "joint_ne": 3}

    # and the plain versions ask ne_layout the same
    seen.clear()
    _, ta, target, params, w = _case(model, 3, v, 82, True)
    _port_rows(model, "full", ta, target, params, w)
    assert seen == [("ne", m, "full", v)]


def test_layout_rule_at_the_main_paths_shapes():
    """One thread a texel below 32 views (the shading batch, both joint
    shapes); a split of 8 warps at the routed fit's 384 views; 4 for K7's
    ``full``, whose 55 partial rows of 8 warps would pass 48 KB of shared
    memory; never a split the kernels refuse, and never fewer than 16 views
    a warp."""
    for kernel, m in (("ne", 3), ("ne", 5), ("ne", 1), ("joint_ne", 9)):
        for mode in MODES:
            for v in (1, 5, 16, 31):
                assert ne.ne_layout(kernel, m, mode, v) == ne.ONE_THREAD
            full_k7 = kernel == "joint_ne" and mode == "full"
            assert ne.ne_layout(kernel, m, mode, 384) == (4 if full_k7 else 8)
            for v in (1, 5, 16, 32, 37, 64, 100, 384, 600, 5000):
                warps = ne.ne_layout(kernel, m, mode, v)
                assert ne.layout_fits(m, mode, warps)
                assert warps == ne.ONE_THREAD or v >= 16 * warps
                assert warps == ne.ne_layout(kernel, m, mode, v)
    assert not ne.layout_fits(9, "full", 8)
    assert ne.layout_fits(9, "grad", 8)
    for warps in (0, 3, 16):
        assert not ne.layout_fits(3, "chi2", warps)
    with pytest.raises(ValueError, match="no layout"):
        ne.ne_layout("lm", 3, "full", 16)


@pytest.mark.parametrize("v", [16, V_PAST_K5])
def test_a_texels_rows_do_not_depend_on_its_batch(v):
    """The split reads no texel count, so K6's and K7's rows of a few texels
    alone are the bits of the same texels' rows within a larger batch."""
    model, t = "cook_torrance", 40
    _, ta, target, params, w = _case(model, t, v, 83, True)
    whole = _port_rows(model, "full", ta, target, params, w)
    few = type(ta)(*(None if a is None else a[:5] for a in ta))
    part = _port_rows(model, "full", few, target[:5], params[:5], w[:5])
    assert torch.equal(part, whole[:, :5])
    _, tg, target, params, w = _joint_case("cook_torrance", t, v, 84, True)
    whole = _joint_port_rows("cook_torrance", "full", tg, target, params, w)
    part = _joint_port_rows("cook_torrance", "full", type(tg)(*(x[:5] for x in tg)), target[:5],
                            params[:5], w[:5])
    assert torch.equal(part, whole[:, :5])


def test_a_layout_the_kernel_refuses_raises_before_a_launch(monkeypatch):
    monkeypatch.setattr(ne, "LAUNCHES", {"ne": 0, "joint_ne": 0})
    monkeypatch.setattr(ne, "ne_layout", lambda *a: 8)
    monkeypatch.setattr(_build, "check_operands", lambda *a: None)
    empty = torch.empty(1)
    with pytest.raises(ValueError, match="does not take a split of 8 warps"):
        ne.joint_ne_rows_cuda("cook_torrance", "full", empty.expand(6, 4, 8), empty.expand(3, 4, 8),
                              empty.expand(3, 4, 8), empty.expand(9, 8), empty.expand(9, 8))
    assert ne.LAUNCHES == {"ne": 0, "joint_ne": 0}
