"""Batched box-constrained Levenberg-Marquardt in eager PyTorch.

Port of ``brdf_tpu/solver/lm.py``: the option, result and stop-code types,
and :func:`levmar_bc`, the Kanzow-style projected LM the pipeline's
``engine="xla"`` runs. The JAX package ``vmap``s one ``lax.while_loop``
state machine over the problems; here the batch is written out with masks:
the outer loop runs while any lane is active, the inner damping loop while
any active lane still retries, and a lane that has stopped keeps its state.
One outer iteration evaluates the Jacobian once; the inner loop retries
``(JᵀJ + μI) δ = −g`` with growing μ until a step is accepted, re-evaluating
only the residual.

Ported: ``levmar_bc`` with an analytic ``jac_fn`` or forward-mode autodiff,
``linsolver="cholesky"``, ``warm_state`` and all counters. Not ported yet
(ROADMAP.md Queue A item 9, each raises ``NotImplementedError``): ``dscl``,
the ``fd``/``fd_central``/``secant`` Jacobians, the ``qr``/``lu``/``svd``/
``ldlt`` linear solvers, a sharded residual axis (``axis_name``),
``levmar``, ``levmar_lec``, ``fd_jacobian`` and ``check_jacobian``.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple

import torch


class StopReason(enum.IntEnum):
    """Termination codes, aligned with levmar ``info[6]``."""

    RUNNING = 0
    SMALL_GRADIENT = 1
    SMALL_DP = 2
    MAX_ITERATIONS = 3
    SINGULAR = 4
    NO_REDUCTION = 5
    SMALL_CHI2 = 6
    INVALID_VALUES = 7


class LMOptions(NamedTuple):
    """Solver controls, with the JAX package's defaults. The VarPro engine
    reads only ``itmax`` (its Newton step count is ``min(itmax, 16)``);
    ``damping="marquardt"`` is an option of the fused tier (``ops/lm.py``)."""

    tau: float = 1e-3
    eps1: float = 1e-15
    eps2: float = 1e-15
    eps3: float = 1e-20
    itmax: int = 100
    max_inner: int = 24
    mu_max: float = 1e32
    axis_name: str | None = None
    linsolver: str = "cholesky"
    damping: str = "add"


class LMResult(NamedTuple):
    p: torch.Tensor          # (..., m) fitted parameters
    chi2: torch.Tensor       # (...,) final ||e||²
    chi2_init: torch.Tensor  # (...,) initial ||e||²
    g_inf: torch.Tensor      # (...,) final projected-gradient inf-norm
    iters: torch.Tensor      # (...,) outer iterations (accepted VarPro steps)
    stop: torch.Tensor       # (...,) StopReason
    nfev: torch.Tensor       # (...,) residual evaluations
    njev: torch.Tensor       # (...,) Jacobian evaluations
    mu: torch.Tensor         # (...,) final damping μ — resume state
    nu: torch.Tensor         # (...,) final ν — resume state
    nlss: torch.Tensor       # (...,) linear systems solved
    constraint_violation: torch.Tensor

    def warm_state(self):
        """(μ, ν, stop) for resuming: lanes stopped at MAX_ITERATIONS are
        reopened (cut off, not converged); other stop codes are final."""
        stop = torch.where(
            self.stop == int(StopReason.MAX_ITERATIONS),
            torch.full_like(self.stop, int(StopReason.RUNNING)),
            self.stop,
        )
        return self.mu, self.nu, stop


_LATER = "ROADMAP.md Queue A item 9 (the rest of levmar)"


def _later(what: str):
    return NotImplementedError(f"{what} is not ported yet: {_LATER}")


def _solve_damped(jtj: torch.Tensor, g: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Solve ``(JᵀJ + μI) δ = −g`` per lane by Cholesky. A lane whose damped
    matrix is not positive definite gets NaN, which the caller's acceptance
    test treats as a rejected step."""
    m = jtj.shape[-1]
    a = jtj + mu[:, None, None] * torch.eye(m, dtype=jtj.dtype, device=jtj.device)
    chol, info = torch.linalg.cholesky_ex(a)
    dp = torch.cholesky_solve(-g[..., None], chol)[..., 0]
    return torch.where((info != 0)[:, None], torch.full_like(dp, float("nan")), dp)


def _prep_bounds(p0, lower, upper):
    m = p0.shape[-1]
    lo = torch.full((m,), -float("inf")) if lower is None else torch.as_tensor(lower)
    hi = torch.full((m,), float("inf")) if upper is None else torch.as_tensor(upper)
    return (lo.to(p0).broadcast_to((m,)), hi.to(p0).broadcast_to((m,)))


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def levmar_bc(
    residual_fn: Callable[..., torch.Tensor],
    p0: torch.Tensor,
    lower=None,
    upper=None,
    data: Any = None,
    opts: LMOptions = LMOptions(),
    jac_fn: Callable[..., torch.Tensor] | None = None,
    data_axes: Any = 0,
    jac_mode: str = "auto",
    warm_state=None,
    dscl=None,
    secant_refresh: int = 10,
) -> LMResult:
    """Box-constrained LM over a batch of independent problems.

    Args:
      residual_fn: ``residual_fn(p (m,), data) -> (n,)`` for ONE problem; the
        solver batches it with ``torch.func.vmap`` and minimises the squared
        norm per problem.
      p0: ``(m,)`` single problem or ``(B, m)`` batch. The solve runs in its
        dtype and on its device.
      lower/upper: box bounds, scalars or ``(m,)`` (``None`` → unconstrained).
      data: per-problem auxiliary tensors (a tensor, or a tuple/dict/named
        tuple of tensors and ``None``s), with a leading batch dimension when
        batched.
      jac_fn: optional analytic Jacobian ``(p, data) -> (n, m)`` for one
        problem; the default is forward-mode autodiff of ``residual_fn``.
      data_axes: 0 (every leaf of ``data`` is batched) or ``None`` (shared).
      warm_state: optional ``(μ, ν, stop)`` triple, typically
        ``prev.warm_state()``, resuming a chunked fit with ``p0 = prev.p``:
        μ ≤ 0 or non-finite takes the Kanzow init, a non-RUNNING stop
        short-circuits the lane.
    """
    if dscl is not None:
        raise _later("levmar_bc(dscl=...)")
    if opts.linsolver != "cholesky":
        raise _later(f"linsolver={opts.linsolver!r}")
    if opts.axis_name is not None:
        raise _later("a sharded residual axis (axis_name)")
    if opts.damping != "add":
        raise ValueError("damping='marquardt' is an option of the fused tier (ops/lm.py) only")
    if jac_fn is None and jac_mode != "auto":
        if jac_mode in ("fd", "fd_central", "secant"):
            raise _later(f"jac_mode={jac_mode!r}")
        raise ValueError(f"unknown jac_mode {jac_mode!r}")
    if data_axes not in (0, None):
        raise ValueError("data_axes is 0 (batched) or None (shared)")

    batched = p0.ndim == 2
    if not batched:
        p0 = p0[None]
        if data_axes == 0:
            data = _tree_map(lambda x: x[None], data)
        if warm_state is not None:
            warm_state = tuple(torch.as_tensor(x)[None] for x in warm_state)
    b = p0.shape[0]
    dtype, dev = p0.dtype, p0.device
    lower_b, upper_b = _prep_bounds(p0, lower, upper)

    if jac_fn is None:
        def jac_fn(p, d):
            return torch.func.jacfwd(lambda q: residual_fn(q, d))(p)

    # None leaves of ``data`` (unused angle channels) stay unbatched
    d_axes = None if data_axes is None else _tree_map(lambda x: 0, data)
    res_b = torch.func.vmap(residual_fn, in_dims=(0, d_axes))
    jac_b = torch.func.vmap(jac_fn, in_dims=(0, d_axes))

    def proj(p):
        return torch.minimum(torch.maximum(p, lower_b), upper_b)

    running = int(StopReason.RUNNING)
    if warm_state is None:
        mu_w = torch.zeros(b, dtype=dtype, device=dev)
        nu_w = torch.full((b,), 2.0, dtype=dtype, device=dev)
        stop_w = torch.full((b,), running, dtype=torch.int32, device=dev)
    else:
        mu_w, nu_w, stop_w = (torch.as_tensor(x, device=dev) for x in warm_state)
        mu_w = mu_w.to(dtype)
        nu_w = torch.where(torch.isfinite(nu_w), nu_w, torch.full_like(nu_w, 2.0)).to(dtype)
        stop_w = stop_w.to(torch.int32)
    mu_w = torch.where(torch.isfinite(mu_w) & (mu_w > 0), mu_w, torch.zeros_like(mu_w))

    def code(c: StopReason, like: torch.Tensor) -> torch.Tensor:
        return torch.full_like(like, int(c))

    with torch.no_grad():
        p = proj(p0)
        e = res_b(p, data)
        chi2 = torch.sum(e * e, -1)
        chi2_0 = chi2
        stop = torch.where(torch.isfinite(chi2), code(StopReason.RUNNING, stop_w),
                           code(StopReason.INVALID_VALUES, stop_w))
        stop = torch.where(stop_w != running, stop_w, stop)
        g_inf = torch.full((b,), float("inf"), dtype=dtype, device=dev)
        mu, nu = mu_w, nu_w
        iters = torch.zeros(b, dtype=torch.int32, device=dev)
        nfev = torch.ones(b, dtype=torch.int32, device=dev)
        njev = torch.zeros(b, dtype=torch.int32, device=dev)
        nlss = torch.zeros(b, dtype=torch.int32, device=dev)
        tiny = torch.finfo(dtype).tiny

        while True:
            act = (stop == running) & (iters < opts.itmax)
            if not bool(act.any()):
                break
            j = jac_b(p, data)                                  # (B, n, m)
            jtj = j.transpose(-1, -2) @ j
            g = (j.transpose(-1, -2) @ e[..., None])[..., 0]

            # projected-gradient convergence measure
            gi = torch.amax(torch.abs(p - proj(p - g)), -1)
            grad_conv = gi <= opts.eps1

            # active-set freeze of bound-stuck coordinates
            frozen = ((p <= lower_b) & (g > 0)) | ((p >= upper_b) & (g < 0))
            free = (~frozen).to(dtype)
            jtj_f = jtj * (free[:, :, None] * free[:, None, :]) + torch.diag_embed(frozen.to(dtype))
            g_f = g * free

            diag_max = torch.amax(torch.diagonal(jtj, dim1=-2, dim2=-1), -1)
            t_mu = torch.where((iters == 0) & (mu <= 0), opts.tau * diag_max, mu)
            t_nu, t_p, t_e, t_chi2 = nu, p, e, chi2
            t_stop = torch.full_like(stop, running)
            t_nfev = nfev
            accepted = torch.zeros_like(act)
            tries = torch.zeros_like(iters)

            while True:
                ia = act & (~accepted) & (t_stop == running) & (tries < opts.max_inner)
                if not bool(ia.any()):
                    break
                dp = _solve_damped(jtj_f, g_f, t_mu)
                pnew = proj(p + dp)
                dpa = pnew - p                                  # the projected step
                dp_norm2 = torch.sum(dpa * dpa, -1)
                p_norm2 = torch.sum(p * p, -1)
                solver_failed = ~torch.isfinite(dp).all(-1)
                small_dp = dp_norm2 <= opts.eps2 * opts.eps2 * p_norm2

                enew = res_b(pnew, data)
                chi2new = torch.sum(enew * enew, -1)
                finite = torch.isfinite(chi2new)
                df = t_chi2 - chi2new
                # predicted reduction −(2 gᵀδ + δᵀ JᵀJ δ), valid for a projected step
                jd = (jtj @ dpa[..., None])[..., 0]
                dl = -(2.0 * torch.sum(g * dpa, -1) + torch.sum(dpa * jd, -1))

                accept = (~solver_failed) & finite & (df > 0)
                rho = torch.where(dl > 0, df / torch.clamp(dl, min=tiny), torch.ones_like(dl))
                tmp = 2.0 * rho - 1.0
                mu_acc = t_mu * torch.clamp(1.0 - tmp * tmp * tmp, min=1.0 / 3.0)
                mu_next = torch.where(accept, mu_acc, t_mu * t_nu)
                nu_next = torch.where(accept, torch.full_like(t_nu, 2.0), t_nu * 2.0)

                st = torch.full_like(stop, running)
                st = torch.where(small_dp & ~solver_failed, code(StopReason.SMALL_DP, st), st)
                st = torch.where(mu_next > opts.mu_max, code(StopReason.NO_REDUCTION, st), st)
                st = torch.where(solver_failed & (t_mu > opts.mu_max / 2),
                                 code(StopReason.SINGULAR, st), st)

                take = ia & accept
                t_p = torch.where(take[:, None], pnew, t_p)
                t_e = torch.where(take[:, None], enew, t_e)
                t_chi2 = torch.where(take, chi2new, t_chi2)
                t_mu = torch.where(ia, mu_next, t_mu)
                t_nu = torch.where(ia, nu_next, t_nu)
                t_stop = torch.where(ia, st, t_stop)
                t_nfev = t_nfev + ia.to(torch.int32)
                accepted = accepted | take
                tries = tries + ia.to(torch.int32)

            st = t_stop
            st = torch.where((st == running) & (~accepted), code(StopReason.NO_REDUCTION, st), st)
            st = torch.where(t_chi2 <= opts.eps3, code(StopReason.SMALL_CHI2, st), st)
            st = torch.where(grad_conv, code(StopReason.SMALL_GRADIENT, st), st)

            p = torch.where(act[:, None], t_p, p)
            e = torch.where(act[:, None], t_e, e)
            chi2 = torch.where(act, t_chi2, chi2)
            g_inf = torch.where(act, gi, g_inf)
            mu = torch.where(act, t_mu, mu)
            nu = torch.where(act, t_nu, nu)
            iters = iters + act.to(torch.int32)
            stop = torch.where(act, st, stop)
            nfev = torch.where(act, t_nfev, nfev)
            njev = njev + act.to(torch.int32)
            nlss = nlss + torch.where(act, tries, torch.zeros_like(tries))

    stop = torch.where(stop == running, code(StopReason.MAX_ITERATIONS, stop), stop)
    res = LMResult(
        p=p, chi2=chi2, chi2_init=chi2_0, g_inf=g_inf, iters=iters, stop=stop, nfev=nfev,
        njev=njev, mu=mu, nu=nu, nlss=nlss, constraint_violation=torch.zeros_like(chi2),
    )
    return res if batched else LMResult(*(x[0] for x in res))


def levmar(*args, **kwargs):
    raise _later("levmar (the unconstrained entry point)")


def levmar_lec(*args, **kwargs):
    raise _later("levmar_lec (linear equality constraints)")


def fd_jacobian(*args, **kwargs):
    raise _later("fd_jacobian (finite-difference Jacobians)")


def check_jacobian(*args, **kwargs):
    raise _later("check_jacobian")
