"""The eager LM loop's step (brdf_tpu_torch/ops/ne.py): the plain step
functions on hand-built lanes that take each branch, at every parameter
count the step kernels (csrc/lm_step.cu) are built for; the CUDA wrappers'
contract with the library stood in for; and the loop's use of the two
steps on the CPU. The kernels themselves run on the card only:
``chip_smoke.py::phase_lm_step`` holds them equal to these plain functions.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from brdf_tpu_torch.ops import _build, lm as k5, ne  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions, StopReason  # noqa: E402

STEP_M = (1, 2, 3, 4, 5, 9)
OPTS = LMOptions(eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=10)
LO, HI = 0.0, 100.0

# the lanes, one a branch
NORMAL, FROZEN, SINGULAR, SINGULAR_STOP, REJECTED, SMALL_DP, SMALL_GRAD, SMALL_CHI2, \
    STOPPED, LAST_ITER, KANZOW = range(11)
T = 11


def _cfg(m):
    return k5.solve_config("cook_torrance", OPTS, (LO,) * m, (HI,) * m)


def _lanes(m):
    """``full (R, T)``, ``p (m, T)``, ``state (6, T)`` and the trial χ² of
    eleven lanes, each built to take one branch of the step."""
    gen = torch.Generator().manual_seed(m)
    a = torch.zeros(T, m, m)
    g = torch.zeros(T, m)
    p = torch.full((T, m), 2.0)
    for lane in range(T):
        j = torch.rand(m + 2, m, generator=gen)
        a[lane] = j.T @ j + 0.5 * torch.eye(m)
        g[lane] = torch.rand(m, generator=gen) * 0.2 + 0.05
    # state rows: χ², μ, ν, iterations, stop, g_inf
    state = torch.tensor([[1.0, 0.01, 2.0, 1.0, 0.0, 3.4e38]] * T).T.contiguous()
    chi2_new = torch.full((T,), 0.5)

    p[FROZEN, 0] = LO                     # at the lower bound, pushed out of the box
    g[FROZEN, 0] = 1.0
    a[SINGULAR] = 0.0                     # no information and no damping: no solve
    state[1, SINGULAR] = 0.0
    state[1, SINGULAR_STOP] = 6e31        # damping past mu_max / 2 and a system it cancels
    a[SINGULAR_STOP] = -6e31 * torch.eye(m)
    chi2_new[REJECTED] = 1.5              # χ² grows: the step is refused
    p[SMALL_DP] = 50.0                    # a step far below eps2 · |p|
    a[SMALL_DP] = 1e6 * torch.eye(m)
    g[SMALL_DP] = 1e-3
    g[SMALL_GRAD] = 0.0                   # a stationary point
    chi2_new[SMALL_CHI2] = 0.0            # the data fitted exactly
    state[4, STOPPED] = float(StopReason.SMALL_DP)
    state[3, LAST_ITER] = float(OPTS.itmax - 1)
    state[1, KANZOW] = 0.0                # no μ carried in at iteration 0: Kanzow's
    state[3, KANZOW] = 0.0

    rows = [torch.zeros(T)]
    for j in range(m):
        for k in range(j, m):
            rows.append(a[:, j, k])
    rows.extend(g[:, j] for j in range(m))
    full = torch.stack(rows).contiguous()
    return full, p.T.contiguous(), state, chi2_new


def _step(m):
    cfg = _cfg(m)
    full, p, state, chi2_new = _lanes(m)
    p0, state0 = p.clone(), state.clone()
    pn, scratch = torch.empty_like(p), torch.empty(6, T)
    active = torch.full((1,), 99, dtype=torch.int32)
    ne.lm_step_propose_plain(cfg, full, p, state, pn, scratch, active)
    assert int(active) == 0                                # the proposal zeroes the count
    out = dict(pn=pn.clone(), scratch=scratch.clone())
    ne.lm_step_accept_plain(cfg, chi2_new, scratch, pn, p, state, active)
    return cfg, full, p0, state0, chi2_new, out, p, state, int(active)


@pytest.mark.parametrize("m", STEP_M)
def test_plain_step_takes_each_branch(m):
    cfg, full, p0, state0, chi2_new, prop, p, state, active = _step(m)
    pn, scratch = prop["pn"], prop["scratch"]
    chi2, mu, nu, it, stop, g_inf = state
    ok, small_dp, grad_conv = scratch[3], scratch[4], scratch[5]

    # an ordinary lane: the step is solved, taken and μ shrinks
    assert ok[NORMAL] == 1 and not torch.equal(pn[:, NORMAL], p0[:, NORMAL])
    assert torch.equal(p[:, NORMAL], pn[:, NORMAL]) and chi2[NORMAL] == chi2_new[NORMAL]
    assert mu[NORMAL] < scratch[0, NORMAL] * 2.0                 # the accepted branch
    assert nu[NORMAL] == 2.0 and it[NORMAL] == 2.0
    assert stop[NORMAL] == 0 and g_inf[NORMAL] == scratch[1, NORMAL]
    assert scratch[2, NORMAL] > 0                           # a predicted reduction

    # frozen at a bound: that coordinate does not move
    assert pn[0, FROZEN] == LO and ok[FROZEN] == 1

    # a singular system: no step, refused, ν doubles, no stop at small μ
    assert ok[SINGULAR] == 0 and torch.equal(pn[:, SINGULAR], p0[:, SINGULAR])
    assert torch.equal(p[:, SINGULAR], p0[:, SINGULAR]) and nu[SINGULAR] == 4.0
    assert stop[SINGULAR] == 0 and chi2[SINGULAR] == state0[0, SINGULAR]
    # ... and at a μ past half of mu_max, SINGULAR (over NO_REDUCTION)
    assert ok[SINGULAR_STOP] == 0 and stop[SINGULAR_STOP] == float(StopReason.SINGULAR)

    # χ² grows: refused, μ grows by ν, ν doubles, the lane keeps p and χ²
    assert ok[REJECTED] == 1 and torch.equal(p[:, REJECTED], p0[:, REJECTED])
    assert chi2[REJECTED] == state0[0, REJECTED] and nu[REJECTED] == 4.0
    assert mu[REJECTED] == scratch[0, REJECTED] * 2.0 and it[REJECTED] == 2.0

    assert small_dp[SMALL_DP] == 1 and grad_conv[SMALL_DP] == 0
    assert stop[SMALL_DP] == float(StopReason.SMALL_DP)
    assert grad_conv[SMALL_GRAD] == 1 and stop[SMALL_GRAD] == float(StopReason.SMALL_GRADIENT)
    assert stop[SMALL_CHI2] == float(StopReason.SMALL_CHI2) and chi2[SMALL_CHI2] == 0.0

    # a lane that has stopped keeps its whole state
    assert torch.equal(p[:, STOPPED], p0[:, STOPPED])
    assert torch.equal(state[:, STOPPED], state0[:, STOPPED])

    # Kanzow's μ = τ · max diag(JᵀJ) where no μ came in at iteration 0
    diag = torch.stack([full[1 + sum(m - i for i in range(j)), KANZOW] for j in range(m)])
    assert scratch[0, KANZOW] == diag.max() * cfg.tau
    assert scratch[0, NORMAL] == state0[1, NORMAL]

    # the active count: lanes still running and under itmax
    assert it[LAST_ITER] == OPTS.itmax and stop[LAST_ITER] == 0
    still = (stop == 0) & (it < OPTS.itmax)
    assert active == int(still.sum()) and not still[LAST_ITER] and still[NORMAL]


@pytest.mark.parametrize("m", STEP_M)
def test_plain_step_is_the_loops_step(m):
    """A pass evaluates the full rows, proposes, evaluates χ² at the trial
    point and accepts, in that order; on CPU tensors the default steps are
    the plain ones (nothing launched, nothing counted), and the loop over
    them equals the loop over the steps passed in its place."""
    cfg = _cfg(m)
    full, p, state, chi2_new = _lanes(m)
    calls = []

    def rows_fn(mode, pr):
        calls.append(mode)
        return full if mode == "full" else chi2_new[None]

    before = dict(ne.LAUNCHES)
    res = ne._lm_loop(cfg._replace(itmax=2), rows_fn, p, None)
    assert ne.LAUNCHES == before
    assert calls[0] == "chi2" and calls[1:] == ["full", "chi2"] * int(res.iters.max())
    assert res.p.shape == (T, m) and res.p.is_contiguous()

    seen = []

    def spy(fn):
        def call(*args):
            seen.append(fn.__name__)
            return fn(*args)
        return call

    calls.clear()
    res_spy = ne._lm_loop(cfg._replace(itmax=2), rows_fn, p, None,
                          steps=(spy(ne.lm_step_propose_plain), spy(ne.lm_step_accept_plain)))
    assert seen == ["lm_step_propose_plain", "lm_step_accept_plain"] * int(res.iters.max())
    for x, y in zip(res, res_spy):
        assert torch.equal(x, y)


def test_steps_on_cpu_tensors_run_the_plain_versions(monkeypatch):
    m = 3
    cfg = _cfg(m)
    full, p, state, chi2_new = _lanes(m)
    pn, scratch = torch.empty_like(p), torch.empty(6, T)
    active = torch.zeros(1, dtype=torch.int32)
    called = []
    monkeypatch.setattr(ne, "lm_step_propose_plain", lambda *a: called.append("propose"))
    monkeypatch.setattr(ne, "lm_step_accept_plain", lambda *a: called.append("accept"))
    monkeypatch.setattr(ne, "_step_cuda", lambda *a: called.append("cuda"))
    ne.lm_step_propose(cfg, full, p, state, pn, scratch, active)
    ne.lm_step_accept(cfg, chi2_new, scratch, pn, p, state, active)
    assert called == ["propose", "accept"]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ne.lm_step_propose(cfg, full.to("meta"), p.to("meta"), state, pn, scratch, active)


class _FakeEntry:
    """Stands in for a step kernel's entry of ``csrc/lm_step.cu``: records its
    arguments and returns the error code it is given."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def _stand_in(monkeypatch, err=0):
    entries = (_FakeEntry(err), _FakeEntry(err))
    by_entry = dict(zip((ne._PROPOSE, ne._ACCEPT), entries))
    monkeypatch.setattr(ne, "LAUNCHES", {"ne": 0, "joint_ne": 0, "lm_step": 0})
    monkeypatch.setattr(_build, "check_operands", lambda *a: None)
    monkeypatch.setattr(ne, "_check_count", lambda *a: None)
    monkeypatch.setattr(_build, "lookup", by_entry.__getitem__)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return entries


@pytest.mark.parametrize("m", STEP_M)
def test_the_wrappers_launch_what_the_plain_versions_take(monkeypatch, m):
    """With the device checks and the library stood in for, each wrapper
    passes m, the operands in the entry's order, T, the float32 bounds and
    constants of the configuration and the stream, and counts one launch."""
    propose, accept = _stand_in(monkeypatch)
    cfg = _cfg(m)
    full, p, state, chi2_new = _lanes(m)
    pn, scratch = torch.empty_like(p), torch.empty(6, T)
    active = torch.zeros(1, dtype=torch.int32)
    ne.lm_step_propose_cuda(cfg, full, p, state, pn, scratch, active)
    assert ne.LAUNCHES["lm_step"] == 1
    ne.lm_step_accept_cuda(cfg, chi2_new, scratch, pn, p, state, active)
    assert ne.LAUNCHES == {"ne": 0, "joint_ne": 0, "lm_step": 2}
    consts = (cfg.eps1, cfg.eps2_sq, cfg.eps3, cfg.mu_max, cfg.half_mu_max, cfg.tau, cfg.itmax, 7)
    for entry, operands in ((propose, (full, p, state, pn, scratch, active)),
                            (accept, (chi2_new, scratch, pn, p, state, active))):
        (args,) = entry.calls
        assert args[0] == m
        assert args[1:7] == tuple(x.data_ptr() for x in operands)
        assert args[7] == T
        assert list(args[8]) == [LO] * m and list(args[9]) == [HI] * m
        assert args[10:] == consts


def test_the_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    _stand_in(monkeypatch)
    full, p, state, chi2_new = _lanes(3)
    pn, scratch = torch.empty_like(p), torch.empty(6, T)
    active = torch.zeros(1, dtype=torch.int32)
    # a parameter count the kernels are not built for, before anything else
    for m in (6, 7, 8, 10, 11):
        pm = torch.zeros(m, T)
        cfg = _cfg(m)
        with pytest.raises(ValueError, match="built for m in"):
            ne.lm_step_propose_cuda(cfg, torch.zeros(ne.ne_rows_count(m, "full"), T), pm, state,
                                    pm.clone(), scratch, active)
        with pytest.raises(ValueError, match="built for m in"):
            ne.lm_step_accept_cuda(cfg, chi2_new, scratch, pm.clone(), pm, state, active)
    with pytest.raises(ValueError, match="built for m in"):
        ne.lm_step_propose_cuda(_cfg(3), full, p[0], state, pn, scratch, active)
    cfg = _cfg(3)
    with pytest.raises(ValueError, match="shapes"):
        ne.lm_step_propose_cuda(cfg, full[:-1], p, state, pn, scratch, active)
    with pytest.raises(ValueError, match="shapes"):
        ne.lm_step_accept_cuda(cfg, chi2_new[:-1], scratch, pn, p, state, active)
    with pytest.raises(ValueError, match="shapes"):
        ne.lm_step_accept_cuda(cfg, chi2_new, scratch[:5], pn, p, state, active)
    with pytest.raises(ValueError, match="bounds"):
        ne.lm_step_propose_cuda(_cfg(2), full, p, state, pn, scratch, active)
    assert ne.LAUNCHES["lm_step"] == 0


def test_a_launch_error_raises_and_is_not_counted(monkeypatch):
    _stand_in(monkeypatch, err=98)
    full, p, state, chi2_new = _lanes(5)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        ne.lm_step_propose_cuda(_cfg(5), full, p, state, torch.empty_like(p), torch.empty(6, T),
                                torch.zeros(1, dtype=torch.int32))
    assert ne.LAUNCHES["lm_step"] == 0


def test_the_wrappers_check_device_type_layout_and_count():
    """Unpatched: CPU tensors, another dtype, a strided operand and a count
    that is not one int32 on the lanes' device are refused before a launch."""
    m = 9
    cfg = _cfg(m)
    full, p, state, chi2_new = _lanes(m)
    pn, scratch = torch.empty_like(p), torch.empty(6, T)
    active = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        ne.lm_step_propose_cuda(cfg, full, p, state, pn, scratch, active)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        ne.lm_step_accept_cuda(cfg, chi2_new, scratch, pn, p, state, active)
    for bad in (active.long(), torch.zeros(2, dtype=torch.int32), active):
        with pytest.raises(ValueError, match="active count"):
            ne._check_count("lm_step_accept", bad, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="active count"):
        ne._check_count("lm_step_accept", active, torch.device("cpu"))


def test_an_empty_lane_set_launches_nothing(monkeypatch):
    propose, accept = _stand_in(monkeypatch)
    cfg = _cfg(2)
    active = torch.full((1,), 5, dtype=torch.int32)
    p = torch.zeros(2, 0)
    ne.lm_step_propose_cuda(cfg, torch.zeros(ne.ne_rows_count(2, "full"), 0), p, torch.zeros(6, 0),
                            p.clone(), torch.zeros(6, 0), active)
    ne.lm_step_accept_cuda(cfg, torch.zeros(0), torch.zeros(6, 0), p.clone(), p, torch.zeros(6, 0),
                           active)
    assert int(active) == 0 and not propose.calls and not accept.calls
    assert ne.LAUNCHES["lm_step"] == 0
