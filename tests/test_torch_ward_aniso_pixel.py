"""The per-pixel anisotropic Ward fit of the benchmark's ``timber-aniso-16led``
configuration, on the CPU at a tiny size (subdiv 2, 80 × 60, 16 views):
the benchmark's plain reference (``gpubench/reference/ward_aniso.py``)
against the port's lobe and tangent-frame angles, the port's
``fit_per_texel(engine="varpro")`` (K8's plain version) against the
reference fit through the cell's own judge and limits, and K8's
``varpro_nd`` span and counters (``utils/profiling.py``)."""

import math

import numpy as np
import pytest
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.ops.varpro_nd import varpro_fit_fused_nd
from brdf_tpu_torch.pipeline.fit import fit_per_texel
from brdf_tpu_torch.utils import profiling
from gpubench import core, program
from gpubench.reference import problem as ref_problem
from gpubench.reference import ward_aniso
from gpubench.tests.test_gpubench_reference import tiny
from gpubench.traffic.scan_aniso import make_scan

CPU = torch.device("cpu")
CELL = "timber-aniso-16led.varpro"
COSINES = (("cos_ln", "ln"), ("cos_nh", "nh"), ("cos_vn", "vn"), ("cos_th", "th"),
           ("cos_bh", "bh"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: torch's thread pool gains nothing on them, and
    beside other test workers on the same cores its waiting threads slow the
    file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recording_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _entry(seed: int):
    cell = tiny(CELL)
    entry = core.entry_module(cell).Entry(cell, seed, CPU)
    entry.traffic = dict(entry.traffic, warm_calls=0)
    entry.pool = 1
    entry.setup()
    return cell, entry


@pytest.fixture(scope="module")
def entry():
    return _entry(2**31 + 19)[1]


def _fit(entry, record: bool):
    s = entry.config["solver"]
    profiling.reset()
    profiling.enable(record)
    try:
        rep = fit_per_texel(entry.problems[0], "ward_aniso", opts=entry.opts, device=CPU,
                            engine="varpro", mask_saturation=s["mask_saturation"],
                            robust=s["robust"], robust_iters=s["robust_iters"],
                            lower=s["lower"], upper=s["upper"])
        return rep, profiling.records(), profiling.counters()
    finally:
        profiling.enable(False)


@pytest.fixture(scope="module")
def fits(entry):
    off = _fit(entry, False)
    on = _fit(entry, True)
    profiling.reset()
    return off, on


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_reference_lobe_equals_the_program(seed):
    g = torch.Generator().manual_seed(seed)
    c = {k: torch.rand(64, 16, generator=g, dtype=torch.float64) * 2 - 1
         for k in ("ln", "nh", "vn", "th", "bh")}
    p = torch.rand(64, 5, generator=g, dtype=torch.float64)
    p[:, 2:4] = p[:, 2:4] * 0.6 + 5e-4          # some alphas below the 1e-3 floor
    p[:, 4] = (p[:, 4] - 0.5) * math.pi
    zero = torch.zeros_like(c["ln"])
    ang = ShadingAngles(cos_ln=c["ln"], cos_nh=c["nh"], cos_rv=zero, cos_vn=c["vn"],
                        cos_th=c["th"], cos_bh=c["bh"], cos_tl=zero, cos_bl=zero,
                        cos_tv=zero, cos_bv=zero)
    want = MODELS["ward_aniso"].fn(p, ang)
    got = ward_aniso.ward_aniso(*(p[:, j:j + 1] for j in range(5)), c)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def cosines_both():
    cfg = tiny(CELL).config
    scan = make_scan(cfg, 41, 1, device=CPU)
    _, entry = _entry(41)
    prob = entry.problem(program.scene(scan))
    ref = ref_problem.build(scan, cfg)
    assert np.array_equal(program.texel_keys(cfg, prob, cfg["scan"]["width"]), ref.keys)
    pts, nrm, eye, lights, *_ = ref_problem.tensors(ref, CPU)
    return prob, ward_aniso.cosines(pts, nrm, eye, lights)


@pytest.mark.parametrize("name,key", COSINES)
def test_tangent_cosines_equal_the_program(cosines_both, name, key):
    prob, c = cosines_both
    got = torch.as_tensor(np.asarray(getattr(prob.angles, name)), dtype=torch.float64)
    assert got.shape == c[key].shape and got.shape[1] == 16
    assert torch.allclose(got, c[key], atol=1e-6), name


@pytest.mark.parametrize("seed", [2**31 + 5, 7])
def test_fit_per_texel_meets_the_cell_limits(seed):
    cell, entry = _entry(seed)
    _, record = entry.request(0)
    numbers = entry.judge([record])
    limits = cell.traffic["check"]["limits"]
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def test_varpro_nd_span_per_round(fits, entry):
    (_, _, _), (rep, spans, _) = fits
    found = [s for s in spans if s.name == "varpro_nd"]
    t = len(entry.keys[0]) * 3
    assert len(found) == 1 + entry.config["solver"]["robust_iters"]
    for s in found:
        assert s.end_ns is not None and s.parent is not None
        assert s.attrs == dict(model="ward_aniso", lanes=t, views=16, grid=18, iters=16,
                               with_p0=False, angles=5)
    assert rep.params.shape == (t // 3, 3, 5)


def test_varpro_nd_counters(fits):
    (_, _, _), (rep, spans, counters) = fits
    rounds = sum(1 for s in spans if s.name == "varpro_nd")
    lanes = rep.result.iters.numel()
    assert counters["varpro_nd.steps"] == rounds * lanes * 16
    # the last round's accepted steps are the result's iterations
    last = int(rep.result.iters.sum())
    assert last <= counters["varpro_nd.accepted"] <= counters["varpro_nd.steps"]


def test_nothing_recorded_off_and_results_identical(fits):
    (rep_off, spans_off, counters_off), (rep_on, _, _) = fits
    assert spans_off == [] and counters_off == {}
    assert torch.equal(rep_off.params, rep_on.params)
    for name in ("chi2", "iters", "stop", "g_inf"):
        assert torch.equal(getattr(rep_off.result, name), getattr(rep_on.result, name)), name


@pytest.mark.parametrize("with_p0", [False, True])
def test_varpro_nd_span_of_a_direct_call(with_p0):
    g = torch.Generator().manual_seed(11)
    t, v = 40, 12
    names = ShadingAngles._fields
    ang = ShadingAngles(**{n: torch.rand(t, v, generator=g) * 2 - 1 for n in names})
    y = torch.rand(t, v, generator=g) * 0.5
    p0 = torch.tensor([[0.3, 0.2, 0.2, 0.3, 0.1]]).expand(t, 5) if with_p0 else None
    off = varpro_fit_fused_nd("ward_aniso", ang, y, p0=p0, iters=5)
    profiling.enable(True)
    on = varpro_fit_fused_nd("ward_aniso", ang, y, p0=p0, iters=5)
    profiling.enable(False)
    (s,) = profiling.records()
    assert s.name == "varpro_nd" and s.attrs["with_p0"] is with_p0
    assert (s.attrs["lanes"], s.attrs["views"], s.attrs["iters"]) == (t, v, 5)
    assert profiling.counters() == {"varpro_nd.steps": t * 5,
                                    "varpro_nd.accepted": int(on.iters.sum())}
    assert torch.equal(off.p, on.p) and torch.equal(off.chi2, on.chi2)
