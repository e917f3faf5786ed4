"""The m = 11 joint normal-map solve of ``ops/joint_levmar.py`` on the CPU:
its analytic Jacobian against forward mode of ``joint_residual`` in float64
(random geometry, offsets at ±max_tilt and at 0, normals on both sides of
the Duff frame's sign switch), ``levmar_bc`` with it against the
forward-mode solve, the dispatch of ``pipeline/fit.py::_joint_solve`` (only
float32 CUDA tensors of an m = 11 base under the Cholesky solve take the
kernel), the wrapper's refusals, and its launch path with the C entry stood
in for. The card tests (marker ``card``) hold the kernel to its plain
version: ``python3 -m pytest --noconftest -m card tests/test_torch_joint_levmar.py``."""

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

import brdf_tpu_torch.pipeline.fit as pfit
from brdf_tpu_torch.models.brdf import ShadingGeometry
from brdf_tpu_torch.models.normalmap import joint_residual, joint_spec
from brdf_tpu_torch.ops import _build
from brdf_tpu_torch.ops import joint_levmar as jl
from brdf_tpu_torch.ops.ne import _joint_prep
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, levmar_bc
from brdf_tpu_torch.utils import profiling

T, V = 12, 16
MAX_TILT = 0.6
OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=40)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small operations: torch's thread pool gains nothing on them, and
    beside other test workers on the same cores its waiting threads slow the
    file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def geometry(seed: int, t: int = T, v: int = V, z=None, dtype=torch.float64):
    """Unit normals (t, 3) and directions to lights and eye (t, v, 3) around
    them, mostly lit; ``z`` sets every normal's z (the Duff frame switches
    sign at 0)."""
    g = torch.Generator().manual_seed(seed)
    n = torch.randn(t, 3, generator=g, dtype=torch.float64)
    if z is not None:
        n[:, 2] = 0.0
        z_col = torch.full((t, 1), z, dtype=torch.float64)
        n = torch.cat([_unit(n)[:, :2] * math.sqrt(1.0 - z * z), z_col], -1)
    n = _unit(n)
    l = _unit(n[:, None] + 0.7 * torch.randn(t, v, 3, generator=g, dtype=torch.float64))
    e = _unit(n[:, None] + 0.5 * torch.randn(t, 1, 3, generator=g, dtype=torch.float64))
    return ShadingGeometry(n.to(dtype), l.to(dtype), e.expand(t, v, 3).contiguous().to(dtype))


def params(seed: int, offsets=None, t: int = T, dtype=torch.float64):
    """(t, 11) parameters inside the box; ``offsets`` pins (nu, nv)."""
    g = torch.Generator().manual_seed(seed + 1000)

    def u(lo, hi, k):
        return lo + (hi - lo) * torch.rand(t, k, generator=g, dtype=torch.float64)

    off = u(-0.3, 0.3, 2) if offsets is None else torch.tensor(
        offsets, dtype=torch.float64).expand(t, 2)
    p = torch.cat([u(0.1, 0.6, 3), u(0.1, 0.5, 3), u(0.15, 0.6, 2), u(-1.5, 1.5, 1), off], -1)
    return p.to(dtype)


def problem(model: str, seed: int, dtype=torch.float64, t: int = T, v: int = V, noise=0.01):
    """A joint problem of ``model``: its geometry, measurements of a truth
    with noise, per-channel weights with a few views masked, and a start
    from the truth's material at untilted normals."""
    spec = joint_spec(model, MAX_TILT)
    geom = geometry(seed, t, v, dtype=dtype)
    truth = params(seed, t=t)
    y = pfit.joint_eval(spec, truth, geometry(seed, t, v))
    g = torch.Generator().manual_seed(seed + 7)
    y = (y + noise * torch.randn(y.shape, generator=g, dtype=torch.float64)).to(dtype)
    w = torch.ones(t, v, 3, dtype=dtype)
    w[:2, :3] = 0.0
    p0 = truth.clone()
    p0[:, 6:9] = torch.tensor([0.4, 0.3, 0.2], dtype=torch.float64)
    p0[:, 9:] = 0.0
    return spec, geom, y, w, p0.to(dtype)


CASES = {
    "random": dict(offsets=None, z=None),
    "roughness_at_the_floor": dict(offsets=None, z=None, floor=True),
    "tilt_at_plus_max": dict(offsets=(MAX_TILT, MAX_TILT), z=None),
    "tilt_at_minus_max": dict(offsets=(-MAX_TILT, MAX_TILT * 0.5), z=None),
    "untilted": dict(offsets=(0.0, 0.0), z=None),
    "z_just_above_the_switch": dict(offsets=(0.0, 0.0), z=0.02),
    "z_just_below_the_switch": dict(offsets=(0.0, 0.0), z=-0.02),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("model", jl.KERNEL_MODELS)
def test_analytic_jacobian_equals_forward_mode(model, case):
    spec = joint_spec(model, MAX_TILT)
    geom = geometry(3, z=CASES[case]["z"])
    p = params(3, CASES[case]["offsets"])
    if CASES[case].get("floor"):
        p[::2, 6] = jl.ROUGH_FLOOR                 # the box's bound, where a projection puts it
        p[::3, 7] = jl.ROUGH_FLOOR
    y = torch.zeros(T, V, 3, dtype=torch.float64)
    w = 0.5 + torch.rand(T, V, 3, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    data = (geom, y, w)
    got = torch.func.vmap(jl.joint_jacobian(spec))(p, data)
    want = torch.func.vmap(torch.func.jacfwd(joint_residual(spec)))(p, data)
    assert got.shape == want.shape == (T, 3 * V, 11)
    # the offset columns are not zero: the tilt reaches the angles
    assert (want[..., 9:].abs().amax(1) > 1e-3).all()
    # relative to the face's Jacobian, and the offsets' columns to their own
    # scale (a lobe at the roughness floor leaves its ks columns near 1e-9)
    face = want.abs().amax((1, 2), keepdim=True)
    assert ((got - want).abs() <= 1e-9 * (want.abs() + face)).all()
    col = want[..., 9:].abs().amax(1, keepdim=True)
    assert ((got[..., 9:] - want[..., 9:]).abs() <= 1e-9 * (want[..., 9:].abs() + col)).all()


@pytest.mark.parametrize("model", jl.KERNEL_MODELS)
def test_levmar_with_the_analytic_jacobian_matches_forward_mode(model):
    spec, geom, y, w, p0 = problem(model, 5)
    opts = OPTS._replace(itmax=20)
    got = jl.joint_levmar_plain(spec, geom, y, p0, w, opts)
    want = levmar_bc(joint_residual(spec), p0, spec.lower, spec.upper, data=(geom, y, w),
                     opts=opts)
    assert torch.equal(got.stop, want.stop) and torch.equal(got.iters, want.iters)
    assert torch.equal(got.nfev, want.nfev) and torch.equal(got.nlss, want.nlss)
    assert torch.allclose(got.p, want.p, rtol=0.0, atol=1e-8)
    assert torch.allclose(got.chi2, want.chi2, rtol=1e-8, atol=1e-14)


class _Like:
    """What ``kernel_takes`` reads of a tensor: its device kind and dtype."""

    def __init__(self, is_cuda=True, dtype=torch.float32):
        self.is_cuda, self.dtype = is_cuda, dtype


TAKES = {
    "float32_cuda_m11": (dict(), True),
    "cpu": (dict(tensor=_Like(is_cuda=False)), False),
    "float64": (dict(tensor=_Like(dtype=torch.float64)), False),
    "m9": (dict(model="cook_torrance"), False),
    "qr": (dict(opts=OPTS._replace(linsolver="qr")), False),
    "marquardt": (dict(opts=OPTS._replace(damping="marquardt")), False),
    "sharded_views": (dict(opts=OPTS._replace(axis_name="view")), False),
}


@pytest.mark.parametrize("case", TAKES)
def test_kernel_takes_only_what_it_is_built_for(case):
    change, want = TAKES[case]
    spec = joint_spec(change.get("model", "cook_torrance_aniso"), MAX_TILT)
    tensors = (_Like(), change.get("tensor", _Like()), _Like())
    assert jl.kernel_takes(spec, change.get("opts", OPTS), *tensors) is want


@pytest.mark.parametrize("model,dtype,linsolver", [
    ("cook_torrance_aniso", torch.float32, "cholesky"),
    ("ward_aniso", torch.float64, "cholesky"),
    ("cook_torrance_aniso", torch.float32, "qr"),
    ("cook_torrance", torch.float32, "cholesky"),
])
def test_the_cpu_dispatch_runs_eager_levmar(monkeypatch, model, dtype, linsolver):
    spec, geom, y, w, p0 = problem(model, 6, dtype=dtype, t=4)
    if spec.n_params == 9:
        p0 = torch.cat([p0[:, :6], p0[:, 6:7], p0[:, 9:]], -1)
    calls = []

    def eager(*args, **kwargs):
        calls.append(kwargs.get("jac_fn"))
        return levmar_bc(*args, **kwargs)

    monkeypatch.setattr(pfit, "levmar_bc", eager)
    launches = jl.LAUNCHES
    opts = OPTS._replace(itmax=3, linsolver=linsolver)
    profiling.reset()
    profiling.enable()
    try:
        res = pfit._joint_solve(model, spec, opts, MAX_TILT, "xla", p0, geom, y, w)
    finally:
        profiling.enable(False)
    assert calls == [None]                          # forward mode, as before
    assert jl.LAUNCHES == launches == 0
    assert res.p.shape == p0.shape and res.p.dtype == dtype
    # a solve that ran eagerly counts no kernel solve
    assert "levmar.kernel_solves" not in profiling.counters()
    profiling.reset()


def _stacks(t=T, v=V, m=11):
    z = torch.zeros
    return [z(6, v, t), z(3, v, t), z(3, v, t), z(9, t), z(m, t)]


REFUSALS = {
    "cpu": (lambda a: a, "takes contiguous float32 CUDA tensors"),
    "float64": (lambda a: a[:1] + [a[1].double()] + a[2:], "takes contiguous float32 CUDA"),
    "lv_shape": (lambda a: [a[0][:5]] + a[1:], r"lv is \(6, V, T\)"),
    "y_shape": (lambda a: a[:1] + [a[1][:, :-1].contiguous()] + a[2:], "shapes"),
    "frame_shape": (lambda a: a[:3] + [a[3][:, :-1].contiguous()] + a[4:], "shapes"),
    "p0_m9": (lambda a: a[:4] + [a[4][:9]], "shapes"),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    change, match = REFUSALS[case]
    if case != "cpu":
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    spec = joint_spec("ward_aniso", MAX_TILT)
    with pytest.raises(ValueError, match=match):
        jl.joint_levmar_cuda("ward_aniso", *change(_stacks()), spec.lower, spec.upper, OPTS)
    assert jl.LAUNCHES == 0


def test_the_wrapper_refuses_other_models_and_solvers(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    spec = joint_spec("ward_aniso", MAX_TILT)
    with pytest.raises(ValueError, match="takes the m = 11 bases"):
        jl.joint_levmar_cuda("cook_torrance", *_stacks(m=9), spec.lower[:9], spec.upper[:9],
                             OPTS)
    with pytest.raises(ValueError, match="Cholesky"):
        jl.joint_levmar_cuda("ward_aniso", *_stacks(), spec.lower, spec.upper,
                             OPTS._replace(linsolver="lu"))
    with pytest.raises(ValueError, match="11 bounds"):
        jl.joint_levmar_cuda("ward_aniso", *_stacks(), spec.lower[:9], spec.upper, OPTS)
    with pytest.raises(ValueError, match="at least one view"):
        jl.lane_layout(0)
    assert jl.LAUNCHES == 0


def _floats(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), (n,))


def _ints(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), (n,))


class _Entry:
    """Stands in for ``brdf_joint_levmar``: reads its operands through their
    pointers, solves them with the plain version and writes its outputs
    through theirs, as the kernel lays them out."""

    def __init__(self, spec):
        self.spec, self.calls = spec, []

    def __call__(self, lobe, lv, y, w, frame, p0, p_out, f_out, n_out, counters, t, v, lanes,
                 lo, hi, tau, eps1, eps2_sq, eps3, mu_max, half_mu_max, itmax, max_inner,
                 stream):
        self.calls.append((lobe, t, v, lanes, list(lo), list(hi), tau, eps1, eps2_sq, eps3,
                           mu_max, half_mu_max, itmax, max_inner, stream))
        def rows(ptr, r, *lead):     # views-major rows → face-major, contiguous
            x = torch.from_numpy(_floats(ptr, r * t * math.prod(lead)).reshape(r, *lead, t))
            return x.permute(*range(x.ndim - 1, -1, -1)).contiguous()

        lv_ = rows(lv, 6, v)
        geom = ShadingGeometry(rows(frame, 9)[:, :3].contiguous(), lv_[..., :3].contiguous(),
                               lv_[..., 3:].contiguous())
        profiling.enable(False)         # the stand-in's own solve records nothing
        res = jl.joint_levmar_plain(self.spec, geom, rows(y, 3, v), rows(p0, 11), rows(w, 3, v),
                                    OPTS._replace(itmax=itmax, max_inner=max_inner))
        profiling.enable()
        _floats(p_out, 11 * t)[:] = res.p.reshape(-1).numpy()
        _floats(f_out, 5 * t)[:] = torch.stack([res.chi2, res.chi2_init, res.g_inf, res.mu,
                                                res.nu]).reshape(-1).numpy()
        _ints(n_out, 5 * t)[:] = torch.stack([res.iters, res.stop, res.nfev, res.njev,
                                              res.nlss]).reshape(-1).numpy()
        _ints(counters, 2)[:] = (t, 1)
        return 0


@pytest.mark.parametrize("model", jl.KERNEL_MODELS)
def test_the_kernel_path_launches_what_the_plain_version_solves(monkeypatch, model):
    """With the device and the C entry stood in for, the dispatch takes the
    kernel path for float32 "CUDA" tensors: one launch with the operands,
    sizes, bounds and float32 constants in the entry's order, results laid
    out as ``levmar_bc``'s, a ``levmar.solve`` span with path "kernel" and
    the lanes counted from the faces' iterations."""
    spec, geom, y, w, p0 = problem(model, 8, dtype=torch.float32, t=6, v=13)
    want = jl.joint_levmar_plain(spec, geom, y, p0, w, OPTS)
    entry = _Entry(spec)
    monkeypatch.setattr(jl, "LAUNCHES", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    monkeypatch.setattr(_build, "lookup", lambda e: entry if e is jl._SOLVE else None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 5}))
    profiling.reset()
    profiling.enable()
    try:
        got = pfit._joint_solve(model, spec, OPTS, MAX_TILT, "xla", p0, geom, y, w)
    finally:
        profiling.enable(False)
    (call,) = entry.calls
    f32 = torch.tensor([OPTS.tau, OPTS.eps1, OPTS.eps2 ** 2, OPTS.eps3, OPTS.mu_max,
                        OPTS.mu_max / 2], dtype=torch.float32).tolist()
    lobe = jl.SHADING_KERNELS[model].lobe_id
    assert call == (lobe, 6, 13, jl.lane_layout(13), pytest.approx(list(spec.lower)),
                    pytest.approx(list(spec.upper)), *f32, OPTS.itmax, OPTS.max_inner, 5)
    assert jl.LAUNCHES == 1
    for name, a, b in zip(LMResult._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    (span,) = [s for s in profiling.records() if s.name == "levmar.solve"]
    assert span.attrs == {"lanes": 6, "m": 11, "n": 39, "path": "kernel"}
    counters = profiling.counters()
    assert counters["levmar.kernel_solves"] == 1
    assert counters["levmar.lanes"] == 6 * int(want.iters.max())
    assert counters["levmar.active_lanes"] == int(want.iters.sum())
    profiling.reset()


HOST_CASES = {f"{m}-S{lanes}-V{v}": (m, lanes, v) for m in jl.KERNEL_MODELS
              for lanes, v in ((1, 16), (8, 16), (32, 16), (8, 13))}


@pytest.mark.parametrize("case", HOST_CASES)
def test_the_kernel_source_on_the_host_solves_as_the_plain_version(case):
    """``csrc/joint_levmar.cu`` itself, built for the host by
    ``tools/joint_levmar_host.py`` (every warp intrinsic a meeting of the 32
    lanes, which refuses a warp whose lanes part): at S lanes a face, with a
    grid that holds every face and with one of two blocks whose groups take
    face after face, the two give the same bits (a face's arithmetic does
    not depend on the group that runs it); the counters keep levmar_bc's
    rules; and the answers agree with the plain version's under the
    agreement tool's median bar (its tail bar needs the card tests'
    thousands of faces: at 64 one face is 1.6%)."""
    from tools import joint_levmar_host as host
    from tools.joint_levmar_agreement import MEDIAN_BAR, agreement

    if not host.available():
        pytest.skip("no host C++ compiler to build the kernel with")
    model, lanes, v = HOST_CASES[case]
    spec, geom, y, w, p0 = problem(model, 9, dtype=torch.float32, t=64, v=v)
    plain = jl.joint_levmar_plain(spec, geom, y, p0, w, OPTS)
    stacks = _joint_prep(geom, y, w)
    whole, refill = (host.solve(model, *stacks, p0.T.contiguous(), spec.lower, spec.upper, OPTS,
                                lanes=lanes, sms=sms) for sms in (132, 1))
    for name, a, b in zip(LMResult._fields, whole, refill):
        assert torch.equal(a, b), name
    got = whole
    assert torch.equal(got.nfev, 1 + got.nlss) and torch.equal(got.njev, got.iters)
    assert bool((got.iters <= OPTS.itmax).all() and (got.nlss <= got.iters * OPTS.max_inner).all())
    assert set(got.stop.tolist()) <= {1, 2, 3, 4, 5, 6}
    lo, hi = torch.tensor(spec.lower), torch.tensor(spec.upper)
    assert bool(((got.p >= lo) & (got.p <= hi)).all())
    assert bool((got.chi2 <= got.chi2_init).all())
    both = agreement(got, plain)
    assert both["chi2_rel_median"] <= MEDIAN_BAR, both


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _result(chi2, stop, iters=None) -> LMResult:
    chi2 = torch.as_tensor(chi2, dtype=torch.float32)
    stop = torch.as_tensor(stop, dtype=torch.int32)
    iters = torch.full_like(stop, 5) if iters is None else torch.as_tensor(iters, dtype=torch.int32)
    z = torch.zeros_like(chi2)
    return LMResult(p=z[:, None].expand(-1, 11), chi2=chi2, chi2_init=chi2 + 1, g_inf=z,
                    iters=iters, stop=stop, nfev=iters + 1, njev=iters, mu=z, nu=z + 2,
                    nlss=iters, constraint_violation=z)


N_FACES = 1000
# the plain version's χ² and stop codes, what the kernel reads in each case,
# and whether it holds the bars and the same-stop reading
AGREEMENT = {
    "the same answers": (lambda c, s: (c, s), True, True),
    "rounding apart": (lambda c, s: (c * (1 + 1e-6 * torch.sin(torch.arange(N_FACES))), s),
                       True, True),
    "worse on a tail of faces": (lambda c, s: (torch.where(torch.arange(N_FACES) % 20 == 0,
                                                           c * 2, c), s), False, True),
    "another stop on an eighth": (lambda c, s: (c, torch.where(torch.arange(N_FACES) % 8 == 0,
                                                               3, s)), True, False),
    "off in the median": (lambda c, s: (c * 1.01, s), False, True),
}


@pytest.mark.parametrize("case", AGREEMENT)
def test_the_agreement_bars(case):
    """The agreement tool's bars: the median |Δχ²| / χ² and the tail (the
    kernel worse on no more faces than the reverse, up to TAIL_BAR) each fail
    a kernel that departs from the plain version in their way, rounding
    alone passes, and the same-stop share is read against its bar apart."""
    from tools.joint_levmar_agreement import agreement

    g = torch.Generator().manual_seed(3)
    chi2 = torch.rand(N_FACES, generator=g) + 0.1
    stop = torch.where(torch.arange(N_FACES) % 3 == 0, 2, 1)
    change, held, same_stop = AGREEMENT[case]
    got = agreement(_result(*change(chi2, stop)), _result(chi2, stop))
    assert got["held"] is held
    assert got["same_stop_held"] is same_stop
    assert got["faces"] == N_FACES


def test_the_consistency_bar_catches_a_chi2_that_is_not_the_models():
    """The tool's check of the kernel's answers against the model: a χ² that
    is ``joint_eval``'s passes, one face whose χ² belongs to another
    function than the model's (a lobe on the other side of a horizon) fails
    the sum and the share."""
    from tools.joint_levmar_agreement import consistency

    spec, geom, y, w, p0 = problem("cook_torrance_aniso", 5, dtype=torch.float32, t=8)
    e = (pfit.joint_eval(spec, p0, geom) - y) * w
    chi2 = (e.double() ** 2).sum((1, 2)).float()
    res = _result(chi2, torch.ones(8, dtype=torch.int32))._replace(p=p0)
    assert consistency(spec, res, geom, y, w)["consistent"]
    off = res._replace(chi2=chi2.clone().index_fill_(0, torch.tensor([3]), 1e-6))
    got = consistency(spec, off, geom, y, w)
    assert not got["consistent"] and got["chi2_consistent_share"] == 7 / 8


@pytest.mark.card
@pytest.mark.parametrize("model", jl.KERNEL_MODELS)
@pytest.mark.parametrize("v", [16, 13, 40])
def test_the_kernel_solves_as_levmar_bc_on_the_card(cuda, model, v):
    """On the card: the kernel's counters obey levmar_bc's rules, its answers
    lie in the box below their start, and its χ² agrees with the plain
    version's under the agreement tool's median and tail bars, and the χ²
    it reports is the model's at its answer."""
    from tools.joint_levmar_agreement import MEDIAN_BAR, TAIL_BAR, agreement, consistency

    spec, geom, y, w, p0 = problem(model, 9, dtype=torch.float32, t=517, v=v)
    geom = ShadingGeometry(*(x.to(cuda) for x in geom))
    y, w, p0 = y.to(cuda), w.to(cuda), p0.to(cuda)
    got = jl.joint_levmar(spec, geom, y, p0, w, OPTS)
    plain = jl.joint_levmar_plain(spec, geom, y, p0, w, OPTS)
    assert torch.equal(got.nfev, 1 + got.nlss) and torch.equal(got.njev, got.iters)
    assert bool((got.iters <= OPTS.itmax).all() and (got.nlss <= got.iters * OPTS.max_inner).all())
    assert set(got.stop.tolist()) <= {1, 2, 3, 4, 5, 6}
    lo, hi = (torch.tensor(b, device=cuda) for b in (spec.lower, spec.upper))
    assert bool(((got.p >= lo) & (got.p <= hi)).all())
    assert bool((got.chi2 <= got.chi2_init).all())
    # the start χ² is the same sum in another order and rounding: a view at a
    # lit mask's edge may fall on the other side of it
    start = (got.chi2_init - plain.chi2_init).abs() / plain.chi2_init
    assert (start <= 1e-5).double().mean().item() >= 0.99
    rel = (got.chi2.double() - plain.chi2.double()).abs() / plain.chi2.double()
    assert rel.median().item() <= MEDIAN_BAR
    both = agreement(got, plain)
    assert both["kernel_worse_share"] <= both["plain_worse_share"] + TAIL_BAR, both
    # the χ² it reports is the model's at its answer (joint_eval on the card)
    own = consistency(spec, got, geom, y, w)
    assert own["consistent"], own


@pytest.mark.card
@pytest.mark.parametrize("views", [16, 32])
def test_the_gain_alternation_follows_the_plain_version_on_the_card(cuda, views):
    """On the card, the timber joint cell's whole gain alternation on one
    scan (and on its views twice over, 32): the main path launches the
    kernel for each solve, its gains stay within the tool's GAIN_BAR of the
    plain version's, and every round's solve passes the solve bars against
    the plain version on the same inputs."""
    import tools.joint_levmar_agreement as jla

    problem, config = jla.cell_problem(2400000021, cuda)
    if views != problem.intensity.shape[1]:
        problem = jla.repeat_views(problem, views // problem.intensity.shape[1])
    got = jla.alternation(problem, config, cuda)
    assert got["kernel_solves"] == config["solver"]["view_gain_rounds"] + 1
    assert got["held"], got
