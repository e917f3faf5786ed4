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

The whole module is ported: :func:`levmar_bc` with an analytic ``jac_fn``,
forward-mode autodiff or the ``fd``/``fd_central``/``secant`` Jacobians,
``dscl``, the five damped-system solvers (``LMOptions.linsolver``), a
``data_axes`` per leaf of ``data``, ``warm_state`` and all counters;
:func:`levmar`, :func:`levmar_lec`, :func:`fd_jacobian`,
:func:`check_jacobian` and :func:`chkjac`. With ``LMOptions.axis_name`` the
residual axis is sharded over the ranks of that axis of the current mesh
(``parallel/mesh.py::use_mesh``): χ², JᵀJ and Jᵀe are per-rank partial sums
added by ``axis_sum``, and the solve and damping control after them are the
same bits on every rank.

While ``utils/profiling.py`` records, a call of :func:`levmar_bc` is a
``levmar.solve`` span (lanes, m, n, jac_mode, path "eager"; the m = 11 joint
fit's kernel, ``ops/joint_levmar.py``, records path "kernel") and each outer
iteration a ``levmar.iter`` span; the counter ``levmar.syncs`` counts every
host test of the lanes (outer and inner), and at the call's end
``levmar.lanes`` (lanes × outer iterations) and ``levmar.active_lanes`` (the
iterations the lanes ran, one read of the device) are added.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple

import torch

from brdf_tpu_torch.parallel.mesh import axis_sum
from brdf_tpu_torch.solver import axb
from brdf_tpu_torch.utils import profiling
from brdf_tpu_torch.utils.profiling import count, span


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


LINSOLVERS = ("cholesky", "qr", "lu", "svd", "ldlt")


def _solve_damped(jtj: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                  method: str = "cholesky") -> torch.Tensor:
    """Solve the damped normal equations ``(JᵀJ + μI) δ = −g`` per lane, by
    one of levmar's Ax=b solvers (``solver/axb.py``; the JAX package's
    ``_solve_damped``). A lane whose system the solver cannot solve (a
    Cholesky factor of a matrix that is not positive definite, a zero pivot,
    non-finite entries) gets non-finite values, which the caller's acceptance
    test treats as a rejected step."""
    m = jtj.shape[-1]
    eye = torch.eye(m, dtype=jtj.dtype, device=jtj.device)
    a = jtj + mu[:, None, None] * eye
    if method == "cholesky":
        chol, info = torch.linalg.cholesky_ex(a)
        dp = torch.cholesky_solve(-g[..., None], chol)[..., 0]
        return torch.where((info != 0)[:, None], torch.full_like(dp, float("nan")), dp)
    # LAPACK's factorizations refuse non-finite input, which XLA's propagate:
    # such lanes solve the identity and come back NaN
    bad = ~torch.isfinite(a).all(-1).all(-1)
    a = torch.where(bad[:, None, None], eye, a)
    solve = {"qr": axb.ax_eq_b_qr, "lu": axb.ax_eq_b_lu, "svd": axb.ax_eq_b_svd,
             "ldlt": axb.ax_eq_b_ldlt}[method]
    dp = solve(a, -g)
    return torch.where(bad[:, None], torch.full_like(dp, float("nan")), dp)


def _prep_bounds(p0, lower, upper):
    m = p0.shape[-1]
    lo = torch.full((m,), -float("inf")) if lower is None else torch.as_tensor(lower)
    hi = torch.full((m,), float("inf")) if upper is None else torch.as_tensor(upper)
    return (lo.to(p0).broadcast_to((m,)), hi.to(p0).broadcast_to((m,)))


def _axes_of(data, axes):
    """The batch axis (0 or None) of every tensor leaf of ``data``, as a tree
    of ``data``'s structure: ``axes`` is 0 or None for every leaf, or a tuple
    matching ``data``'s top level whose entries are again 0, None or tuples
    (the JAX package's ``data_axes``, a prefix of the data's tree)."""
    if isinstance(axes, (tuple, list)):
        if not isinstance(data, (tuple, list)) or len(axes) != len(data):
            raise ValueError("a tuple data_axes must match data's leaves")
        kids = [_axes_of(d, a) for d, a in zip(data, axes)]
        return type(data)(*kids) if hasattr(data, "_fields") else type(data)(kids)
    if axes not in (0, None):
        raise ValueError("data_axes is 0 (batched), None (shared), or a tuple of them "
                         "matching data's leaves")
    if isinstance(data, torch.Tensor):
        return axes
    if hasattr(data, "_fields"):
        return type(data)(*(_axes_of(x, axes) for x in data))
    if isinstance(data, (tuple, list)):
        return type(data)(_axes_of(x, axes) for x in data)
    if isinstance(data, dict):
        return {k: _axes_of(v, axes) for k, v in data.items()}
    return None


def _add_batch(data, axes):
    """Give the batched leaves of one problem's ``data`` a batch of one."""
    if isinstance(data, torch.Tensor):
        return data[None] if axes == 0 else data
    if hasattr(data, "_fields"):
        return type(data)(*(_add_batch(x, a) for x, a in zip(data, axes)))
    if isinstance(data, (tuple, list)):
        return type(data)(_add_batch(x, a) for x, a in zip(data, axes))
    if isinstance(data, dict):
        return {k: _add_batch(v, axes[k]) for k, v in data.items()}
    return data


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
    """Box-constrained LM over a batch of independent problems (replaces
    ``dlevmar_bc_der``/``dlevmar_bc_dif``, ``levmar/levmar.h:126-146``).

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
      data_axes: 0 (every leaf of ``data`` is batched), ``None`` (shared), or
        a tuple matching ``data``'s leaves, e.g. ``(None, 0, None)``.
      jac_mode: "auto" (forward-mode AD), "fd" (forward differences, the
        ``*_dif`` behaviour, ``misc_core.c:137-172``), "fd_central", or
        "secant" (Broyden rank-1 updates between full forward-difference
        refreshes every ``secant_refresh`` iterations, and whenever ν > 16 —
        ``LEVMAR_DIF``'s scheme, ``lm_core.c:578-588``). Ignored when
        ``jac_fn`` is given, except that "secant" still updates it.
      warm_state: optional ``(μ, ν, stop)`` triple, typically
        ``prev.warm_state()``, resuming a chunked fit with ``p0 = prev.p``:
        μ ≤ 0 or non-finite takes the Kanzow init, a non-RUNNING stop
        short-circuits the lane.
      dscl: optional ``(m,)`` positive diagonal scaling: the solve runs on
        ``p/dscl`` (bounds, steps and the eps2 test in scaled variables) and
        unscales the result, levmar's ``dscl`` (``lmbc_core.c:360-366``).

    ``opts.axis_name`` names the axis of the current mesh over which each
    problem's residuals are split (the ``"view"`` axis of
    ``parallel/fit.py::fit_texels_sharded``): every sum over the residual
    axis is then an ``axis_sum`` of the ranks' partial sums, as the JAX
    package ``psum``s them.
    """
    if opts.damping != "add":
        raise ValueError("damping='marquardt' is an option of the fused tier (ops/lm.py) only")
    if opts.linsolver not in LINSOLVERS:
        raise ValueError(f"unknown linsolver {opts.linsolver!r}; choose from {LINSOLVERS}")

    if dscl is not None:
        dscl = torch.as_tensor(dscl).to(p0).broadcast_to((p0.shape[-1],))
        inner_residual, inner_jac = residual_fn, jac_fn

        def residual_fn(ps, d):
            return inner_residual(ps * dscl, d)

        if inner_jac is not None:
            # chain rule: columns of J scale by dscl (lmbc_core.c:575-580)
            def jac_fn(ps, d):
                return inner_jac(ps * dscl, d) * dscl[None, :]

        res = levmar_bc(
            residual_fn, p0 / dscl,
            None if lower is None else torch.as_tensor(lower).to(p0) / dscl,
            None if upper is None else torch.as_tensor(upper).to(p0) / dscl,
            data=data, opts=opts, jac_fn=jac_fn, data_axes=data_axes, jac_mode=jac_mode,
            warm_state=warm_state, secant_refresh=secant_refresh,
        )
        return res._replace(p=res.p * dscl)

    if jac_fn is not None:
        jac_of = jac_fn
    elif jac_mode == "auto":
        def jac_of(p, d):
            return torch.func.jacfwd(lambda q: residual_fn(q, d))(p)
    elif jac_mode in ("fd", "fd_central", "secant"):
        # "secant" refreshes by forward differences like LEVMAR_DIF
        # (lmbc_core.c:1043-1054) and Broyden-updates in between
        def jac_of(p, d):
            return fd_jacobian(residual_fn, p, d, central=(jac_mode == "fd_central"))
    else:
        raise ValueError(f"unknown jac_mode {jac_mode!r}")
    secant_k = int(secant_refresh) if jac_mode == "secant" else 0

    d_axes = _axes_of(data, data_axes)
    batched = p0.ndim == 2
    if not batched:
        p0 = p0[None]
        data = _add_batch(data, d_axes)
        if warm_state is not None:
            warm_state = tuple(torch.as_tensor(x)[None] for x in warm_state)
    b = p0.shape[0]
    dtype, dev = p0.dtype, p0.device
    lower_b, upper_b = _prep_bounds(p0, lower, upper)

    res_b = torch.func.vmap(residual_fn, in_dims=(0, d_axes))
    jac_v = torch.func.vmap(jac_of, in_dims=(0, d_axes))

    def jac_b(p, d):
        # forward-mode AD under vmap can promote a tangent to float64 where a
        # Python scalar meets a per-problem scalar: keep the solve's dtype
        return jac_v(p, d).to(p.dtype)

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

    def rsum(x: torch.Tensor) -> torch.Tensor:
        """A sum over the residual axis, across the ranks of ``axis_name``."""
        return axis_sum(x, opts.axis_name)

    jac_name = "jac_fn" if jac_fn is not None else jac_mode
    with torch.no_grad(), span("levmar.solve", lanes=b, m=p0.shape[-1], jac_mode=jac_name,
                               path="eager") as sp:
        p = proj(p0)
        e = res_b(p, data)
        sp.set(n=e.shape[-1])
        chi2 = rsum(torch.sum(e * e, -1))
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
        if secant_k:
            # the Broyden carry: J, the point and residual it is valid at, its age
            jac_c, p_prev, e_prev = jac_b(p, data), p, e
            age = torch.zeros(b, dtype=torch.int32, device=dev)
            njev = torch.ones_like(njev)

        # one host test of the lanes a pass: ``levmar.iter`` runs from an
        # iteration's first launch to the test that ends it
        passes = 0
        act = (stop == running) & (iters < opts.itmax)
        more = bool(act.any())
        count("levmar.syncs")
        while more:
            with span("levmar.iter"):
                nu_in = nu
                if secant_k:
                    dp_s, de_s = p - p_prev, e - e_prev
                    den = torch.sum(dp_s * dp_s, -1)
                    # rank-1 secant: J += ((Δe − J Δp) Δpᵀ)/‖Δp‖² (lm_core.c:578-588)
                    outer = ((de_s - (jac_c @ dp_s[..., None])[..., 0])[..., :, None]
                             * dp_s[..., None, :])
                    j_upd = jac_c + outer / torch.clamp(den, min=tiny)[:, None, None]
                    j_upd = torch.where((den > tiny)[:, None, None], j_upd, jac_c)
                    # refresh on age, and whenever damping has blown up through
                    # rejected steps (ν > 16), with ν reset as lm_core.c:587 does
                    nu_blown = nu > 16.0
                    refresh = (age >= secant_k) | nu_blown
                    j = j_upd
                    count("levmar.syncs")
                    if bool((refresh & act).any()):
                        j = torch.where(refresh[:, None, None], jac_b(p, data), j_upd)
                    age_n = torch.where(refresh, torch.zeros_like(age), age + 1)
                    nu_in = torch.where(nu_blown, torch.full_like(nu, 2.0), nu)
                    dj = refresh.to(torch.int32)
                else:
                    j = jac_b(p, data)                              # (B, n, m)
                    dj = torch.ones_like(njev)
                jtj = rsum(j.transpose(-1, -2) @ j)
                g = rsum((j.transpose(-1, -2) @ e[..., None])[..., 0])

                # projected-gradient convergence measure
                gi = torch.amax(torch.abs(p - proj(p - g)), -1)
                grad_conv = gi <= opts.eps1

                # active-set freeze of bound-stuck coordinates
                frozen = ((p <= lower_b) & (g > 0)) | ((p >= upper_b) & (g < 0))
                free = (~frozen).to(dtype)
                jtj_f = (jtj * (free[:, :, None] * free[:, None, :])
                         + torch.diag_embed(frozen.to(dtype)))
                g_f = g * free

                diag_max = torch.amax(torch.diagonal(jtj, dim1=-2, dim2=-1), -1)
                t_mu = torch.where((iters == 0) & (mu <= 0), opts.tau * diag_max, mu)
                t_nu, t_p, t_e, t_chi2 = nu_in, p, e, chi2
                t_stop = torch.full_like(stop, running)
                t_nfev = nfev
                accepted = torch.zeros_like(act)
                tries = torch.zeros_like(iters)

                while True:
                    ia = act & (~accepted) & (t_stop == running) & (tries < opts.max_inner)
                    count("levmar.syncs")
                    if not bool(ia.any()):
                        break
                    dp = _solve_damped(jtj_f, g_f, t_mu, opts.linsolver)
                    pnew = proj(p + dp)
                    dpa = pnew - p                                  # the projected step
                    dp_norm2 = torch.sum(dpa * dpa, -1)
                    p_norm2 = torch.sum(p * p, -1)
                    solver_failed = ~torch.isfinite(dp).all(-1)
                    small_dp = dp_norm2 <= opts.eps2 * opts.eps2 * p_norm2

                    enew = res_b(pnew, data)
                    chi2new = rsum(torch.sum(enew * enew, -1))
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
                st = torch.where((st == running) & (~accepted), code(StopReason.NO_REDUCTION, st),
                                 st)
                st = torch.where(t_chi2 <= opts.eps3, code(StopReason.SMALL_CHI2, st), st)
                st = torch.where(grad_conv, code(StopReason.SMALL_GRADIENT, st), st)

                if secant_k:
                    jac_c = torch.where(act[:, None, None], j, jac_c)
                    p_prev = torch.where(act[:, None], p, p_prev)
                    e_prev = torch.where(act[:, None], e, e_prev)
                    age = torch.where(act, age_n, age)
                p = torch.where(act[:, None], t_p, p)
                e = torch.where(act[:, None], t_e, e)
                chi2 = torch.where(act, t_chi2, chi2)
                g_inf = torch.where(act, gi, g_inf)
                mu = torch.where(act, t_mu, mu)
                nu = torch.where(act, t_nu, nu)
                iters = iters + act.to(torch.int32)
                stop = torch.where(act, st, stop)
                nfev = torch.where(act, t_nfev, nfev)
                njev = njev + torch.where(act, dj, torch.zeros_like(dj))
                nlss = nlss + torch.where(act, tries, torch.zeros_like(tries))
                passes += 1
                act = (stop == running) & (iters < opts.itmax)
                more = bool(act.any())
                count("levmar.syncs")
        if profiling.enabled():
            # lanes × passes, and the lanes that ran summed: one device read
            count("levmar.lanes", b * passes)
            count("levmar.active_lanes", int(iters.sum()))

    stop = torch.where(stop == running, code(StopReason.MAX_ITERATIONS, stop), stop)
    res = LMResult(
        p=p, chi2=chi2, chi2_init=chi2_0, g_inf=g_inf, iters=iters, stop=stop, nfev=nfev,
        njev=njev, mu=mu, nu=nu, nlss=nlss, constraint_violation=torch.zeros_like(chi2),
    )
    return res if batched else LMResult(*(x[0] for x in res))


def levmar(
    residual_fn, p0, data=None, opts=LMOptions(), jac_fn=None, data_axes=0, warm_state=None,
) -> LMResult:
    """Unconstrained LM (replaces ``dlevmar_der``/``dlevmar_dif``,
    ``levmar/levmar.h:106-124``): the box solver with infinite bounds, whose
    projection and projected-gradient test reduce to the identity and the
    plain ``‖JᵀE‖_inf`` test of ``lm_core.c``."""
    return levmar_bc(
        residual_fn, p0, None, None, data=data, opts=opts, jac_fn=jac_fn,
        data_axes=data_axes, warm_state=warm_state,
    )


def levmar_lec(
    residual_fn,
    p0: torch.Tensor,
    A,
    b,
    data: Any = None,
    opts: LMOptions = LMOptions(),
    data_axes: Any = 0,
) -> LMResult:
    """Linear-equality-constrained LM: minimize ``‖r(p)‖²`` s.t. ``A p = b``.

    Null-space elimination as ``levmar/lmlec_core.c:92+``: with ``Aᵀ = QR``,
    every feasible point is ``p = c + Z y`` where ``c`` is the min-norm
    solution of ``A c = b`` and ``Z`` spans ``null(A)``; the problem reduces
    to unconstrained LM over ``y ∈ R^{m-k}``.
    """
    A = torch.as_tensor(A).to(p0)
    b = torch.as_tensor(b).to(p0)
    k = A.shape[0]
    q_full, _ = torch.linalg.qr(A.T, mode="complete")  # (m, m)
    z = q_full[:, k:]                                   # (m, m-k) null-space basis
    c = A.T @ torch.linalg.solve(A @ A.T, b)            # min-norm particular sol.

    def reduced_residual(y, d):
        return residual_fn(c + z @ y, d)

    batched = p0.ndim == 2
    y0 = (p0 - c[None, :]) @ z if batched else z.T @ (p0 - c)
    res = levmar(reduced_residual, y0, data=data, opts=opts, data_axes=data_axes)
    p_fit = c[None, :] + res.p @ z.T if batched else c + z @ res.p
    return res._replace(p=p_fit)


# ---------------------------------------------------------------------------
# Jacobian utilities (levmar/misc_core.c equivalents)
# ---------------------------------------------------------------------------


def fd_jacobian(
    residual_fn, p: torch.Tensor, data=None, delta: float = 1e-6, central: bool = True
) -> torch.Tensor:
    """Finite-difference Jacobian ``(n, m)`` of one problem with levmar's
    per-element step rule ``d_j = max(1e-4·|p_j|, δ)``
    (``levmar/misc_core.c:137-211``)."""
    m = p.shape[-1]
    d = torch.clamp(1e-4 * torch.abs(p), min=delta)
    unit = torch.eye(m, dtype=p.dtype, device=p.device)

    def col(j):
        dp = unit[j] * d[j]
        if central:
            return (residual_fn(p + dp, data) - residual_fn(p - dp, data)) / (2 * d[j])
        return (residual_fn(p + dp, data) - residual_fn(p, data)) / d[j]

    return torch.stack([col(j) for j in range(m)], dim=-1)


def _jacobian(residual_fn, p, data, jac_fn):
    if jac_fn is None:
        return torch.func.jacfwd(lambda q: residual_fn(q, data))(p)
    return jac_fn(p, data)


def check_jacobian(
    residual_fn, p: torch.Tensor, data=None, jac_fn=None, delta: float = 1e-6
) -> torch.Tensor:
    """Relative agreement between the autodiff (or supplied) Jacobian and a
    central-difference one — the role of ``dlevmar_chkjac``
    (``levmar/misc_core.c:250-321``). Returns the max relative error."""
    jac = _jacobian(residual_fn, p, data, jac_fn)
    fd = fd_jacobian(residual_fn, p, data, delta=delta)
    scale = torch.clamp(torch.abs(jac) + torch.abs(fd), min=1e-8)
    return torch.amax(torch.abs(jac - fd) / scale)


def chkjac(residual_fn, p: torch.Tensor, data=None, jac_fn=None) -> torch.Tensor:
    """Per-residual Jacobian correctness scores in [0, 1] — the MINPACK-CHKDER
    port levmar ships as ``dlevmar_chkjac`` (``levmar/misc_core.c:250-321``).

    For each residual component the score grades how well the directional
    derivative predicted by the Jacobian matches the actual change of the
    residual under the CHKDER probe point ``pp_j = p_j + √ε·|p_j|``: 1.0 =
    agreement to machine precision, 0.0 = no significant agreement, with a
    log-interpolated grade in between. Returns ``(n,)``."""
    fi = torch.finfo(p.dtype)
    epsmch = torch.tensor(fi.eps, dtype=p.dtype, device=p.device)
    eps = torch.sqrt(epsmch)
    epsf = 100.0 * epsmch
    epslog = torch.log10(eps)

    jac = _jacobian(residual_fn, p, data, jac_fn)

    # CHKDER mode-1 probe point: perturb every component at once
    temp_j = torch.where(p == 0, eps, eps * torch.abs(p))
    pp = p + temp_j
    fvec = residual_fn(p, data)
    fvecp = residual_fn(pp, data)

    # mode-2 scoring (misc_core.c:289-319)
    scale_j = torch.where(torch.abs(p) == 0, torch.ones_like(p), torch.abs(p))
    err = jac @ scale_j                                   # Σ_j |p_j|·J_ij
    df = fvecp - fvec
    significant = (fvec != 0) & (fvecp != 0) & (torch.abs(df) >= epsf * torch.abs(fvec))
    temp = torch.where(
        significant,
        eps * torch.abs(df / eps - err) / (torch.abs(fvec) + torch.abs(fvecp)),
        torch.ones_like(fvec),
    )
    score = torch.ones_like(fvec)
    score = torch.where((temp > epsmch) & (temp < eps), (torch.log10(temp) - epslog) / epslog,
                        score)
    return torch.where(temp >= eps, torch.zeros_like(score), score)
