"""``fit_per_texel(engine="varpro")`` for the m=4 and m=5 lobes against the
program the JAX package runs for them, on synthetic texels × 3 channels × 16
views: rounds of ``varpro_fit_pallas_nd(interpret=True)`` (K8) for the
anisotropic lobes on tangent-frame angles, rounds of the eager
``varpro_fit_fresnel_lin`` for cook_torrance_fresnel, each round with its own
grid init and huber weights, as ``brdf_tpu/parallel/fit.py:80-123`` routes
them on one device.

The float32 solves are chaotic at one ulp (test_torch_varpro_nd.py), so
whole fits are held by outcome: the same calls and counters, recovery within
0.03, χ² at the floor.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import MODELS as J_MODELS, ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.models.brdf import shading_angles as j_shading_angles  # noqa: E402
from brdf_tpu.ops.varpro_pallas import varpro_fit_pallas_nd  # noqa: E402
from brdf_tpu.pipeline.fit import TexelProblem as JProblem  # noqa: E402
from brdf_tpu.solver.robust import robust_weights, saturation_weights  # noqa: E402
from brdf_tpu.solver.varpro import varpro_fit_fresnel_lin as j_fresnel_lin  # noqa: E402
from brdf_tpu_torch import convert  # noqa: E402
from brdf_tpu_torch.parallel import fit as tfit  # noqa: E402
from brdf_tpu_torch.pipeline.fit import FitReport, fit_per_texel  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402
from brdf_tpu_torch.utils.checkpoint import FitCheckpointer, latest_step  # noqa: E402
from torch_port_inputs import angle_columns, aniso_geometry, aniso_recovery, recovery, true_params  # noqa: E402

T, V, C = 64, 16, 3
OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=60)      # k = min(60, 16)
# solver settings: the timber-aniso preset (brdf_tpu/configs.py:185-194), the
# anisotropic Cook-Torrance and the Fresnel lobe with their default boxes
CASES = {
    "timber-aniso": dict(model="ward_aniso", lower=(0.0, 0.0, 1e-3, 1e-3, -1.5707963),
                         upper=(2.0, 2.0, 1.0, 1.0, 1.5707963)),
    "ct-aniso": dict(model="cook_torrance_aniso", lower=None, upper=None),
    "ct-fresnel": dict(model="cook_torrance_fresnel", lower=None, upper=None),
}


def _problem(model, seed):
    rng = np.random.default_rng(seed)
    if J_MODELS[model].tangent:
        pts, nrm, eye, lights = aniso_geometry(rng, T, V)
        ja = j_shading_angles(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(eye),
                              jnp.asarray(lights), tangent_frame=True)
        ang = JAngles(*(None if a is None else np.asarray(a, np.float32) for a in ja))
    else:
        ang = JAngles(**angle_columns(rng, T, V))
    true_p = np.stack([true_params(model, rng, T) for _ in range(C)], 1)      # (T, C, m)
    inten = np.stack([np.asarray(J_MODELS[model].fn(jnp.asarray(true_p[:, c]), ang))
                      for c in range(C)], -1).astype(np.float32)             # (T, V, C)
    return JProblem(angles=ang, intensity=inten, weights=np.ones((T, V), np.float32),
                    face_ids=np.arange(T)), true_p


def _tpu_program(problem, model, lower, upper, rounds=2, k=16):
    """The channel fold, the saturation mask, then the JAX package's VarPro
    tier for this lobe in every round with its own grid init, under huber
    weights from round 1."""
    ang = jax.tree.map(lambda a: np.repeat(np.asarray(a), C, axis=0), problem.angles)
    y = jnp.asarray(np.asarray(problem.intensity).transpose(0, 2, 1).reshape(T * C, V))
    w = jnp.repeat(jnp.asarray(problem.weights), C, axis=0) * saturation_weights(y)
    box = dict(lower=None if lower is None else tuple(lower),
               upper=None if upper is None else tuple(upper))
    if model == "cook_torrance_fresnel":
        def solve(wi):
            return j_fresnel_lin(ang, y, weights=wi, iters=k, **box)
    else:
        def solve(wi):
            return varpro_fit_pallas_nd(model, ang, y, weights=wi, iters=k, block_t=128,
                                        interpret=True, **box)
    r = solve(w)
    for _ in range(rounds):
        r = solve(robust_weights(J_MODELS[model].fn(r.p, ang) - y, w, kind="huber"))
    return r


def _quality(model, p, true_p):
    return aniso_recovery(p, true_p) if J_MODELS[model].tangent else recovery(p, true_p)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_per_texel_varpro_matches_the_tpu_program(case, monkeypatch):
    cfg = CASES[case]
    model = cfg["model"]
    m = J_MODELS[model].n_params
    problem, true_p = _problem(model, seed=len(case))
    calls = []
    tier = "varpro_fit_fresnel_lin" if model == "cook_torrance_fresnel" else "varpro_fit_fused_nd"
    real = getattr(tfit, tier)
    monkeypatch.setattr(tfit, tier, lambda *a, **kw: calls.append(kw.get("p0")) or real(*a, **kw))
    rep = fit_per_texel(convert.from_numpy(problem), model, opts=OPTS, device="cpu",
                        engine="varpro", robust="huber", robust_iters=2,
                        lower=cfg["lower"], upper=cfg["upper"])
    # one solve per round, each from its own grid init
    assert calls == [None, None, None]
    assert isinstance(rep, FitReport) and rep.params.shape == (T, C, m)
    assert rep.result.chi2.shape == (T, C) and rep.result.p.shape == (T * C, m)
    np.testing.assert_array_equal(rep.result.nfev.numpy(), 17)
    np.testing.assert_array_equal(rep.result.njev.numpy(), 16)
    np.testing.assert_array_equal(rep.result.nlss.numpy(), 16)
    np.testing.assert_array_equal(np.isin(rep.result.stop.numpy().ravel(), (2, 3)), True)
    assert float(rep.result.mu.abs().max()) == 0.0
    pt = rep.params.numpy().reshape(T * C, m)
    assert np.isfinite(pt).all()
    lo = np.asarray(J_MODELS[model].lower if cfg["lower"] is None else cfg["lower"], np.float32)
    hi = np.asarray(J_MODELS[model].upper if cfg["upper"] is None else cfg["upper"], np.float32)
    assert ((pt >= lo) & (pt <= hi)).all()

    rj = _tpu_program(problem, model, cfg["lower"], cfg["upper"])
    tp = true_p.reshape(T * C, m)
    assert abs(_quality(model, pt, tp) - _quality(model, np.asarray(rj.p), tp)) <= 0.03
    floor = 1e-12 if model == "cook_torrance_fresnel" else 1e-10
    assert float(rep.result.chi2.median()) < floor
    assert float(np.median(np.asarray(rj.chi2))) < floor


def test_chunked_varpro_fit_resumes_from_its_start(tmp_path, monkeypatch):
    """``chunk_iters`` with ``engine="varpro"`` on ward_aniso: the first chunk
    runs K8's grid init, every later chunk starts from the parameters the
    last one returned (the resume carries the start, as for K1); a run killed
    after its first chunk and resumed ends where the straight run ends."""
    problem, _ = _problem("ward_aniso", seed=3)
    tp = convert.from_numpy(problem)
    opts = OPTS._replace(itmax=16)
    kw = dict(opts=opts, device="cpu", engine="varpro", robust=None, chunk_iters=8)
    calls = []
    real = tfit.varpro_fit_fused_nd

    def spy(*a, **k):
        calls.append(k.get("p0"))
        return real(*a, **k)

    monkeypatch.setattr(tfit, "varpro_fit_fused_nd", spy)
    straight = fit_per_texel(tp, "ward_aniso", checkpointer=FitCheckpointer(str(tmp_path / "a")), **kw)
    assert len(calls) == 2 and calls[0] is None and calls[1] is not None
    assert latest_step(str(tmp_path / "a")) == 16
    whole = fit_per_texel(tp, "ward_aniso", opts=opts, device="cpu", engine="varpro", robust=None)
    assert float(straight.result.chi2.median()) <= max(5.0 * float(whole.result.chi2.median()), 1e-12)
    np.testing.assert_array_equal(straight.result.nfev.numpy()[straight.result.stop.numpy() == 3], 18)

    # killed after the first chunk, then resumed from its checkpoint
    ckpt = FitCheckpointer(str(tmp_path / "b"))
    monkeypatch.setattr(tfit, "varpro_fit_fused_nd", real)
    first = fit_per_texel(tp, "ward_aniso", checkpointer=ckpt, **dict(kw, opts=opts._replace(itmax=8)))
    assert latest_step(ckpt.path) == 8
    calls.clear()
    monkeypatch.setattr(tfit, "varpro_fit_fused_nd", spy)
    resumed = fit_per_texel(tp, "ward_aniso", checkpointer=ckpt, **kw)
    assert len(calls) == 1 and calls[0] is not None
    np.testing.assert_array_equal(calls[0].numpy(), first.result.p.numpy())
    np.testing.assert_array_equal(resumed.params.numpy(), straight.params.numpy())
