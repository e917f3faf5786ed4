"""The linear grid init's one-launch kernel (``csrc/grid_init.cu``) and its
plain version (``ops/grid_init.py``).

On the CPU: the plain version starts every lane at the first grid point of
least cost, its solve clipped to the box, for every lobe (with and without
weights, with zero-weight and all-NaN lanes); ``linear_grid_init``'s choice
of path and the launch counter over a stubbed launcher; the wrapper's
refusals; the ``fit.init`` span's ``path``; the module imports without
building anything. The plain version's solves are held against the JAX
package in ``test_torch_solver.py``.

On a card (marked ``card``; without one they skip): the kernel against the
plain version on the same CUDA inputs, for all ten lobes, under the bar of
``tools/grid_init_agreement.py``. The two sum a texel's views in different
orders, so their costs differ in the last bits of a V-term float32 sum: the
same grid point wherever the plain version's best two costs differ by more
than 1e-5 relative, else a point that ties with the least within that; the
linear parts within 1e-5 relative, or 16·κ·2⁻²⁴ where the point's Gram
matrix has the condition number κ, up to 1e-3, and past that the cost alone;
every start's cost within 1e-5 of Σ w·y² of the plain version's at its
point. Run them on the card with
``python -m pytest --noconftest -m card tests/test_torch_grid_init.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles, ShadingGeometry
from brdf_tpu_torch.ops import grid_init, ne
from brdf_tpu_torch.ops.shading import SHADING_KERNELS
from brdf_tpu_torch.solver import init
from brdf_tpu_torch.utils import profiling
from tools.grid_init_agreement import agreement, point_solves
from torch_port_inputs import ALL_LOBES, angle_columns, true_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs, not when the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_counter():
    grid_init.LAUNCHES = 0
    profiling.enable(False)
    profiling.reset()
    yield
    grid_init.LAUNCHES = 0
    profiling.enable(False)
    profiling.reset()


def _case(model, t=48, v=16, seed=0, device="cpu", dtype=torch.float32):
    """Angles with tangent channels, targets of known parameters with 2%
    noise, weights in [0.2, 1] with a zero-weight lane (1) and an all-NaN
    lane (2), and a masked view (3) on one lane."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v, np.float64, tangent=True)
    ang = ShadingAngles(**{k: torch.tensor(x, dtype=dtype, device=device) for k, x in cols.items()})
    p = torch.tensor(true_params(model, rng, t, np.float64), dtype=dtype, device=device)
    y = MODELS[model].fn(p, ang)
    y = y * torch.tensor(1.0 + 0.02 * rng.standard_normal(y.shape), dtype=dtype, device=device)
    w = torch.tensor(rng.uniform(0.2, 1.0, y.shape), dtype=dtype, device=device)
    if t > 3:
        w[1] = 0.0
        y[2] = float("nan")
        w[0, 3] = 0.0
    return ang, y, w


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_plain_version_starts_at_the_first_least_cost_point(model, weighted):
    """Each lane's start is the clipped solve of the first grid point of
    least cost; a NaN cost never wins, so a lane where every cost is NaN
    keeps zeros, clipped; on a zero-weight lane every cost is 0 and the
    first point wins with zero linear parts."""
    ang, y, w = _case(model, seed=ALL_LOBES.index(model))
    w = w if weighted else None
    spec = MODELS[model]
    grid = init.default_shape_grid(model)
    got = init.linear_grid_init(model, ang, y, weights=w)
    assert got.dtype == torch.float32 and got.shape == (48, spec.n_params)
    starts, costs = point_solves(model, ang, y, grid, w)
    costs = torch.where(torch.isnan(costs), torch.inf, costs)
    first = torch.argmin(costs, 0)              # the first of equal least costs
    won = torch.isfinite(costs.min(0).values)
    want = starts[first, torch.arange(48)]
    assert torch.equal(got[won], want[won])
    lo, hi = torch.tensor(spec.lower), torch.tensor(spec.upper)
    assert bool(((got >= lo) & (got <= hi)).all())
    if weighted:
        assert not won[2] and torch.equal(got[2], torch.maximum(torch.zeros_like(lo), lo))
        assert (costs[:, 1] == 0).all() and int(first[1]) == 0
        assert torch.equal(got[1, :spec.linear], torch.zeros(spec.linear))
    else:
        assert won[:2].all() and not won[2]


def test_init_path_matrix():
    f32, f64 = torch.float32, torch.float64
    assert init.init_path("cuda", f32, False, None) == "kernel"
    assert init.init_path("cuda", f32, False, "view") == "eager"     # sums cross ranks
    assert init.init_path("cuda", f32, True, None) == "eager"        # the refine
    assert init.init_path("cuda", f64, False, None) == "eager"
    assert init.init_path("cpu", f32, False, None) == "eager"


def _stub_launcher(calls):
    """A stand-in for ``grid_init_cuda`` on CPU tensors: the stacked inputs
    checked for contiguity, the eager algorithm on them unstacked, and the
    launch counted."""
    def launch(model, ang, y, w, grid):
        calls.append((model, tuple(ang.shape), None if w is None else tuple(w.shape),
                      np.asarray(grid).shape))
        assert ang.is_contiguous() and y.is_contiguous() and (w is None or w.is_contiguous())
        names = SHADING_KERNELS[model].angle_names
        angles = ShadingAngles(**{**{n: None for n in ShadingAngles._fields},
                                  **dict(zip(names, ang))})
        grid_init.LAUNCHES += 1
        return grid_init.linear_grid_init_plain(model, angles, y, grid, w)
    return launch


@pytest.mark.parametrize("model", ["blinn_phong", "lambert", "ward_aniso"])
def test_kernel_path_stacks_flattens_and_counts_one_launch(monkeypatch, model):
    """The kernel path through a stubbed launcher: one launch a call, the
    lobe's angle channels stacked (A, T, V), leading axes flattened and
    restored, broadcast weights expanded, the result the plain version's."""
    calls = []
    monkeypatch.setattr(grid_init, "grid_init_cuda", _stub_launcher(calls))
    monkeypatch.setattr(init, "init_path", lambda *a: "kernel")
    ang, y, w = _case(model, t=12)
    ang = ShadingAngles(*(None if a is None else a.reshape(3, 4, 16) for a in ang))
    y, w = y.reshape(3, 4, 16), w.reshape(3, 4, 16)
    want = grid_init.linear_grid_init_plain(model, ang, y, init.default_shape_grid(model), w)
    got = init.linear_grid_init(model, ang, y, weights=w)
    assert grid_init.LAUNCHES == 1 and got.shape == (3, 4, MODELS[model].n_params)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    a_count = len(SHADING_KERNELS[model].angle_names)
    k = MODELS[model].n_params - MODELS[model].linear
    assert calls[-1] == (model, (a_count, 12, 16), (12, 16), (len(init.default_shape_grid(model)), k))
    # one weight row for every texel, broadcast; no weights: None reaches the kernel
    init.linear_grid_init(model, ang, y, weights=w[0, 0])
    init.linear_grid_init(model, ang, torch.cat([y, y], -1)[..., ::2])      # not contiguous
    assert calls[-2][2] == (12, 16) and calls[-1][2] is None and grid_init.LAUNCHES == 3


@pytest.mark.parametrize("case", ["axis", "refine", "float64", "cpu"])
def test_eager_paths_launch_nothing(monkeypatch, case):
    """A view axis, the refine, float64 and the CPU take the eager solves
    even where the device would take the kernel."""
    calls = []
    monkeypatch.setattr(grid_init, "grid_init_cuda", _stub_launcher(calls))
    device_type = "cpu" if case == "cpu" else "cuda"
    real = init.init_path
    monkeypatch.setattr(init, "init_path", lambda _dev, *a: real(device_type, *a))
    ang, y, w = _case("blinn_phong", dtype=torch.float64 if case == "float64" else torch.float32)
    kw = dict(weights=w, refine=case == "refine",
              axis_name="view" if case == "axis" else None)
    if case == "axis":
        monkeypatch.setattr(grid_init, "axis_sum", lambda x, name: x)  # one rank
    out = init.linear_grid_init("blinn_phong", ang, y, **kw)
    assert not calls and grid_init.LAUNCHES == 0 and out.dtype == y.dtype


def test_span_carries_the_path(monkeypatch):
    ang, y, w = _case("cook_torrance", t=8)
    profiling.enable()
    init.linear_grid_init("cook_torrance", ang, y, weights=w)
    monkeypatch.setattr(grid_init, "grid_init_cuda", _stub_launcher([]))
    monkeypatch.setattr(init, "init_path", lambda *a: "kernel")
    init.linear_grid_init("cook_torrance", ang, y, weights=w)
    spans = [s for s in profiling.records() if s.name == "fit.init"]
    assert [s.attrs.get("path") for s in spans] == ["eager", "kernel"]


def _args(model="blinn_phong", t=4, v=16, dtype=torch.float32):
    a = len(SHADING_KERNELS[model].angle_names)
    return (torch.zeros(a, t, v, dtype=dtype), torch.zeros(t, v, dtype=dtype),
            torch.ones(t, v, dtype=dtype), init.default_shape_grid(model))


@pytest.mark.parametrize("fault,match", [
    ("dtype", "float32"), ("device", "CUDA"), ("contiguous", "contiguous"),
    ("ang_shape", "shapes"), ("w_shape", "shapes"), ("grid_width", "grid"),
    ("grid_size", "grid"), ("model", "no lobe"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault, match):
    model = "blinn_phong"
    ang, y, w, grid = _args(model)
    if fault == "dtype":
        ang, y, w = (x.double() for x in (ang, y, w))
    elif fault == "contiguous":
        y = torch.zeros(16, 4).T
    elif fault == "ang_shape":
        ang = torch.zeros(3, 4, 16)
    elif fault == "w_shape":
        w = torch.ones(4, 15)
    elif fault == "grid_width":
        grid = np.ones((16, 2))
    elif fault == "grid_size":
        grid = np.ones((grid_init.MAX_GRID + 1, 1))
    elif fault == "model":
        model = "no_such_lobe"
    with pytest.raises(ValueError, match=match):
        grid_init.grid_init_cuda(model, ang, y, w, grid)
    assert grid_init.LAUNCHES == 0


@pytest.mark.parametrize("v", [1, 16, 37, 200, 400])
@pytest.mark.parametrize("n_angles", [1, 2, 3, 4, 5, 9])
def test_kernel_layout_holds_every_view(n_angles, v):
    """S a power of two up to 32 and VPL = ⌈V / S⌉ within a lane's budget,
    else the long-view layout of 32 lanes; S · block_t is the block."""
    lanes, vpl, block_t = grid_init.kernel_layout(n_angles, v)
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes * block_t == grid_init.THREADS
    assert vpl == -(-v // lanes) and (vpl - 1) * lanes < v <= vpl * lanes
    if v <= grid_init.max_views(n_angles):
        assert vpl * (n_angles + 2) <= grid_init.LANE_STATE_FLOATS
    else:
        assert lanes == 32


def test_module_imports_without_building_or_loading():
    code = """
import sys
from brdf_tpu_torch.ops import _build, grid_init
from brdf_tpu_torch.solver import init
assert "grid_init" in _build.SOURCES and not _build.BUILD_LOGS
assert _build.load.cache_info().currsize == 0 and _build.lookup.cache_info().currsize == 0
assert grid_init.LAUNCHES == 0 and "triton" not in sys.modules
print("clean")
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-2000:]


def _channels(model, t=40, v=16, seed=0, per_channel=True):
    """(T, V) angles, (T, V, 3) targets and weights, (T, V, 3) or (T, V),
    with a zero-weight lane, an all-NaN lane and one NaN channel."""
    ang, _, _ = _case(model, t, v, seed)
    rng = np.random.default_rng(seed + 1)
    y = torch.tensor(rng.uniform(0.0, 1.0, (t, v, 3)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0.2, 1.0, (t, v, 3) if per_channel else (t, v)),
                     dtype=torch.float32)
    w[1] = 0.0
    y[2] = float("nan")
    y[3, :, 1] = float("nan")
    return ang, y, w


@pytest.mark.parametrize("weights", ["per_channel", "shared"])
@pytest.mark.parametrize("model", ["minnaert", "cook_torrance_fresnel", *ne.JOINT_MODELS])
def test_channels_folded_into_one_call_are_the_per_channel_starts(model, weights):
    """The fits start every channel with one call: the angles as (T, 1, V)
    against contiguous (T, C, V) targets and weights give, bit for bit, the
    per-channel calls' (T, m) starts stacked on axis 1 (a one-shape lobe, a
    two-shape lobe and the joint fit's base lobes; weights per channel or
    shared by the channels)."""
    ang, y, w = _channels(model, per_channel=weights == "per_channel")
    w3 = w if w.ndim == 3 else w[..., None].expand(y.shape)
    per = torch.stack([init.linear_grid_init(model, ang, y[..., c], weights=w3[..., c])
                       for c in range(3)], dim=1)
    folded = init.linear_grid_init(model, ShadingAngles(*(a[:, None] for a in ang)),
                                   y.transpose(1, 2).contiguous(),
                                   weights=w3.transpose(1, 2).contiguous())
    assert folded.shape == (40, 3, MODELS[model].n_params)
    assert torch.equal(folded, per)


class _Started(Exception):
    """Stops a fit once it has its start."""


@pytest.mark.parametrize("fit", ["joint", "varpro_joint", "single_material"])
def test_the_fits_start_every_channel_in_one_call(monkeypatch, fit):
    """``fit_joint_normalmap``, ``varpro_fit_joint`` and
    ``fit_single_material`` call ``linear_grid_init`` once for all channels
    and start where the per-channel calls did."""
    from brdf_tpu_torch.models.brdf import angles_from_geometry
    from brdf_tpu_torch.models.normalmap import joint_p0_from_channelwise
    from brdf_tpu_torch.pipeline import fit as pfit
    from brdf_tpu_torch.pipeline.fit import TexelProblem
    from brdf_tpu_torch.solver import varpro_joint
    from torch_port_inputs import joint_problem

    base = "blinn_phong" if fit == "single_material" else "cook_torrance"
    geom_np, _, rng = joint_problem(24, 16, seed=5, base=base)
    geom = ShadingGeometry(**{k: torch.tensor(x) for k, x in geom_np.items()})
    ang = angles_from_geometry(geom)
    y = torch.tensor(rng.uniform(0.0, 1.0, (24, 16, 3)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0.2, 1.0, (24, 16)), dtype=torch.float32)
    w3 = w[..., None].expand(y.shape)
    per = torch.stack([init.linear_grid_init(base, ang, y[..., c], weights=w3[..., c])
                       for c in range(3)], dim=1)
    mod = varpro_joint if fit == "varpro_joint" else pfit
    calls, seen = [], []
    real = mod.linear_grid_init
    monkeypatch.setattr(mod, "linear_grid_init",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def started(*args, **kw):
        seen.append(args)
        raise _Started

    prob = TexelProblem(angles=ang, intensity=y, weights=w, face_ids=np.arange(24),
                        geometry=geom)
    if fit == "joint":
        monkeypatch.setattr(pfit, "_joint_solve", started)
        with pytest.raises(_Started):
            pfit.fit_joint_normalmap(prob, base, device="cpu", mask_saturation=False)
        assert torch.equal(seen[0][5], joint_p0_from_channelwise(per))
    elif fit == "varpro_joint":
        monkeypatch.setattr(varpro_joint, "joint_p0_from_channelwise", started)
        with pytest.raises(_Started):
            varpro_joint.varpro_fit_joint(base, geom, y, weights=w, iters=1)
        assert torch.equal(seen[0][0], per)
    else:
        monkeypatch.setattr(pfit, "levmar_bc", started)
        with pytest.raises(_Started):
            pfit.fit_single_material(prob, base, device="cpu")
        assert torch.equal(seen[0][1], pfit._median0(per))
    assert calls == [1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _hold_kernel_to_plain(model, ang, y, w, grid=None):
    grid = init.default_shape_grid(model) if grid is None else grid
    before = grid_init.LAUNCHES
    got = grid_init.linear_grid_init_fused(model, ang, y, grid, w)
    torch.cuda.synchronize()
    assert grid_init.LAUNCHES == before + 1
    held = agreement(model, ang, y, grid, w, got)
    assert not held["failures"] and held["edge_lanes"] < held["lanes"], (model, held)
    return held


@pytest.mark.card
@pytest.mark.parametrize("v", [16, 37])
@pytest.mark.parametrize("model", ALL_LOBES)
def test_kernel_holds_to_plain_on_the_card(card, model, v):
    ang, y, w = _case(model, t=517, v=v, seed=7, device=card)
    _hold_kernel_to_plain(model, ang, y, w)
    _hold_kernel_to_plain(model, ang, y, None)


@pytest.mark.card
@pytest.mark.parametrize("model", ["cook_torrance", "blinn_phong", "ward_aniso", "lambert"])
@pytest.mark.parametrize("t", [8203, 8191])
def test_kernel_holds_at_the_benchmark_lanes(card, model, t):
    ang, y, w = _case(model, t=t, v=16, seed=t, device=card)
    _hold_kernel_to_plain(model, ang, y, w)


@pytest.mark.card
@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "cook_torrance_aniso"])
def test_kernel_long_view_path_and_user_grid(card, model):
    """Past the register layouts (32 lanes reading their views anew), a user
    grid, masked views, all-NaN and all-zero lanes."""
    a_count = len(SHADING_KERNELS[model].angle_names)
    v = grid_init.max_views(a_count) + 7
    assert grid_init.kernel_layout(a_count, v)[0] == 32
    ang, y, w = _case(model, t=131, v=v, seed=3, device=card)
    w[5, ::3] = 0.0
    y[6] = float("nan")
    y[7] = 0.0
    w[8] = 0.0
    _hold_kernel_to_plain(model, ang, y, w)
    k = MODELS[model].n_params - MODELS[model].linear
    rng = np.random.default_rng(1)
    lo, hi = np.asarray(MODELS[model].lower[-k:]), np.asarray(MODELS[model].upper[-k:])
    user = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (grid_init.MAX_GRID, k))
    _hold_kernel_to_plain(model, ang, y, w, grid=user)


@pytest.mark.card
def test_linear_grid_init_takes_the_kernel_on_the_card(card):
    ang, y, w = _case("cook_torrance", t=64, device=card)
    init.linear_grid_init("cook_torrance", ang, y, weights=w)
    init.linear_grid_init("cook_torrance", ang, y, weights=w, refine=True)
    init.linear_grid_init("cook_torrance", ShadingAngles(*(None if a is None else a.double()
                                                           for a in ang)),
                          y.double(), weights=w.double())
    assert grid_init.LAUNCHES == 1
    ang, y, w = _case("blinn_phong", t=0, device=card)
    assert init.linear_grid_init("blinn_phong", ang, y, weights=w).shape == (0, 3)
