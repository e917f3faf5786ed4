"""The anisotropic joint normal map with rig gains of the benchmark's
``timber-joint-aniso-16led`` configuration, on the CPU at a small size
(64 faces × 16 views in the rig's frame): the benchmark's plain reference
(``gpubench/reference/joint_aniso.py``) against the port's ``joint_eval``
for ``cook_torrance_aniso`` at m = 11 and against the Jacobian that
``levmar_bc`` takes of it, and ``fit_joint_normalmap_with_gains`` against
the reference's alternation, with a planted gain fault that the comparison
catches."""

import math

import numpy as np
import pytest
import torch

import brdf_tpu_torch.pipeline.fit as pfit
from brdf_tpu_torch.models.brdf import ShadingGeometry, angles_from_geometry_np
from brdf_tpu_torch.models.normalmap import joint_eval, joint_residual, joint_spec
from brdf_tpu_torch.pipeline.fit import TexelProblem, fit_joint_normalmap_with_gains
from brdf_tpu_torch.solver.lm import LMOptions
from gpubench.reference import joint_aniso, lobes
from gpubench.traffic.scan import CENTER, EYE, led_rig

T, V = 64, 16
TAU = 1e-4
SPEC = joint_spec("cook_torrance_aniso", 0.6)
# the configuration's solver, stopped at 10 iterations: the alternations start at the optimum
OPTS = LMOptions(tau=1e-3, eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: torch's thread pool gains nothing on them, and
    beside other test workers on the same cores its waiting threads slow the
    file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def faces(seed: int, spread: float = 0.35):
    """T faces on the scan sphere around the point facing the eye: unit
    normals (T, 3) and unit directions to the rig's lights and the eye
    (T, V, 3), float64."""
    g = torch.Generator().manual_seed(seed)
    eye, center = (torch.tensor(x, dtype=torch.float64) for x in (EYE, CENTER))
    n = lobes._unit(lobes._unit(eye - center) + spread * torch.randn(T, 3, generator=g,
                                                                      dtype=torch.float64))
    l, v = lobes.directions(center + 30.0 * n, eye, torch.as_tensor(led_rig()[:V]))
    return n, l, v


def params(seed: int, rough=(0.15, 0.6), tilt: float = 0.3) -> torch.Tensor:
    """(T, 11) parameters drawn as the configuration's truth."""
    g = torch.Generator().manual_seed(seed + 1000)

    def u(lo, hi, k):
        return lo + (hi - lo) * torch.rand(T, k, generator=g, dtype=torch.float64)

    return torch.cat([u(0.1, 0.6, 3), u(0.1, 0.5, 3), u(*rough, 2),
                      u(-math.pi / 2, math.pi / 2, 1), u(-tilt, tilt, 2)], -1)


def geometry32(n, l, v) -> ShadingGeometry:
    return ShadingGeometry(n.float(), l.float(), v.float())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_joint_eval_equals_the_reference(seed):
    n, l, v = faces(seed)
    p = params(seed)
    p[:4, 6:8] = 5e-4                                    # some roughness below the floor
    want = joint_aniso.joint_model(n, l, v, p)           # (T, 3, V)
    # float64: the same operations in the same order
    assert torch.equal(joint_eval(SPEC, p, ShadingGeometry(n, l, v)).permute(0, 2, 1), want)
    # float32, as the card runs it
    got = joint_eval(SPEC, p.float(), geometry32(n, l, v)).permute(0, 2, 1).double()
    big = want.abs() > 1e-3
    assert big.sum() > T * V
    assert ((got - want).abs() / want.abs())[big].max() <= 1e-5


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_levmar_jacobian_equals_float64_autograd_of_the_reference(seed):
    n, l, v = faces(seed)
    p = params(seed)
    y = joint_aniso.joint_model(n, l, v, params(seed + 7))
    # what levmar_bc takes: forward mode of one face's residual, under vmap
    data = (geometry32(n, l, v), y.permute(0, 2, 1).float(), torch.ones(T, V, 3))
    res = joint_residual(SPEC)
    got = torch.func.vmap(torch.func.jacfwd(res))(p.float(), data).double()   # (T, 3V, 11)

    def ref(q, nn, ll, vv, yy):
        r = joint_aniso.joint_model(nn[None], ll[None], vv[None], q[None])[0] - yy
        return r.permute(1, 0).reshape(-1)

    want = torch.func.vmap(torch.func.jacrev(ref))(p, n, l, v, y)
    scale = want.abs().amax(1, keepdim=True)              # a face's column
    assert ((got - want).abs() / (want.abs() + 1e-3 * scale + 1e-30)).max() <= 1e-3


def _alternations(seed: int):
    """Both alternations on an untilted scan of equal LEDs, each round of
    each started from the truth's channel parameters (the port's
    ``channel_report``, the reference's ``p0``): → the RMS residuals (T,)
    of the port's and of the reference's answers, and their gains (V,)."""
    from brdf_tpu_torch.pipeline.fit import FitReport

    n, l, v = faces(seed)
    p = params(seed, tilt=0.0)
    y = torch.round(joint_aniso.joint_model(n, l, v, p).clamp(0.0, 1.0) * 65535.0) / 65535.0
    geom = ShadingGeometry(*(x.float().numpy() for x in (n, l, v)))
    prob = TexelProblem(angles=angles_from_geometry_np(geom, tangent_frame=True),
                        intensity=y.permute(0, 2, 1).float().numpy(),
                        weights=np.ones((T, V), np.float32), face_ids=np.arange(T), geometry=geom)
    chan = torch.stack([p[:, [c, 3 + c, 6, 7, 8]] for c in range(3)], 1).float()
    rep = FitReport(params=chan, face_ids=prob.face_ids, result=None, model=SPEC.base_model)
    res, _, g_port = fit_joint_normalmap_with_gains(prob, SPEC.base_model, rounds=2, opts=OPTS,
                                                    max_tilt=0.6, engine="xla", device="cpu",
                                                    channel_report=rep)
    w = (y < 0.98).double()                              # seen everywhere, the saturation mask
    p0 = torch.cat([p[:, :9], torch.zeros(T, 2, dtype=torch.float64)], -1)
    p_ref, g_ref, _ = joint_aniso.fit_joint_gains(n, l, v, y, w, SPEC.lower, SPEC.upper, 2,
                                                  lm_iters=4, p0=p0)
    g_port = torch.as_tensor(g_port, dtype=torch.float64)

    def rms(q, g):
        r = w * (joint_aniso.joint_model(n, l, v, q) * g - y)
        return torch.sqrt((r * r).sum((1, 2)) / w.sum((1, 2)))

    return rms(res.p.double(), g_port), rms(p_ref, g_ref), g_port, g_ref


def _agree(seed: int) -> tuple[float, float]:
    r_port, r_ref, g_port, g_ref = _alternations(seed)
    close = float(((r_port - r_ref).abs() <= TAU).double().mean())
    return close, float(((g_port - g_ref).abs() / g_ref).max())


@pytest.mark.parametrize("seed", [4, 5])
def test_fit_with_gains_agrees_with_the_reference_alternation(seed):
    close, gap = _agree(seed)
    assert close >= 0.9 and gap <= 1e-2, (close, gap)


def test_a_planted_gain_fault_is_caught(monkeypatch):
    real = pfit.estimate_view_gains

    def off_by_five_percent(*args, **kwargs):
        g = real(*args, **kwargs) * (1.0 + 0.05 * (-1.0) ** np.arange(V))
        return g / g.mean()

    monkeypatch.setattr(pfit, "estimate_view_gains", off_by_five_percent)
    close, gap = _agree(4)
    assert not (close >= 0.9 and gap <= 1e-2), (close, gap)
