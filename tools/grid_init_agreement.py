"""The bar the grid init kernel (``csrc/grid_init.cu``) is held to against its
plain version (``ops/grid_init.py::linear_grid_init_plain``) on the same
CUDA inputs, shared by the card tests (``tests/test_torch_grid_init.py``)
and ``chip_smoke.py``'s grid init phase.

The two sum a texel's views in different orders (a lane group's partials and
XOR butterfly against ``torch.sum``'s reduction), so their costs and solves
differ in the last bits of a V-term float32 sum. The bar:

- a lane is *decided* where the plain version's best two grid costs differ
  by more than 1e-5 relative; a closer tie may go either way. On a decided
  lane the kernel picks the plain version's grid point;
- there the linear parts agree within ``max(1e-5, 16·κ·2⁻²⁴)`` relative to
  the lane's larger part, κ the condition number of the point's weighted
  2×2 Gram matrix: a sum's relative rounding reaches the solve multiplied by
  κ. That bar is capped at :data:`LINEAR_CAP`; a decided lane whose κ would
  need more (the two bases nearly collinear) is held by its cost alone;
- a lane that is not decided starts at one of the points whose cost ties
  with the least within 1e-5, with that point's start, held as above;
- on every lane with a finite cost, decided or not, the start's Gram-form
  cost in float64 at its grid point lies within :data:`COST_RTOL` of
  ``Σ w·y²`` of the plain version's start at that point: where the bases are
  nearly collinear a wrong (kd, ks) costs more, however the parts split;
- lanes where every cost is NaN (no point wins) or 0 (the first point wins)
  are equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles
from brdf_tpu_torch.ops import grid_init

TIE_RTOL = 1e-5
LINEAR_RTOL = 1e-5
LINEAR_CAP = 1e-3
COST_RTOL = 1e-5
EPS32 = 2.0**-24


def _grid(model: str, grid, like: torch.Tensor) -> torch.Tensor:
    k = MODELS[model].n_params - MODELS[model].linear
    g = np.asarray(grid, np.float64).reshape(-1, k) if k else np.zeros((1, 0))
    return torch.as_tensor(g, dtype=like.dtype, device=like.device)


def point_solves(model: str, angles: ShadingAngles, target, grid, weights=None):
    """The plain version's solve at each grid point: its starts clipped to
    the box, ``(G, T, n_params)``, and its costs, ``(G, T)``."""
    spec = MODELS[model]
    g = _grid(model, grid, target)
    w = torch.ones_like(target) if weights is None else weights
    solves = [grid_init._solve_linear(spec, angles, w, target * w, g[i]) for i in range(g.shape[0])]
    lo, hi = (target.new_tensor(b) for b in (spec.lower, spec.upper))
    return (torch.stack([torch.minimum(torch.maximum(p, lo), hi) for p, _ in solves]),
            torch.stack([c for _, c in solves]))


def _gram64(model: str, angles: ShadingAngles, target, weights, shape):
    """Each texel's weighted Gram matrix and right side at its own shape
    values, in float64: ``(aa, ab, bb, ay, by)``, or ``(aa, ay)`` for the
    lobes linear in one parameter."""
    spec = MODELS[model]
    f64 = ShadingAngles(*(None if a is None else a.double() for a in angles))
    sh = shape.double()
    one = torch.ones(sh.shape[0], 1, dtype=sh.dtype, device=sh.device)
    y = target.double()
    w = torch.ones_like(y) if weights is None else weights.double()
    a = spec.fn(torch.cat(([one] if spec.linear == 1 else [one, 0 * one]) + [sh], -1), f64)
    if spec.linear == 1:
        return (a * w * a).sum(-1), (a * w * y).sum(-1)
    b = spec.fn(torch.cat([0 * one, one, sh], -1), f64)
    return ((a * w * a).sum(-1), (a * w * b).sum(-1), (b * w * b).sum(-1),
            (a * w * y).sum(-1), (b * w * y).sum(-1))


def _cost64(model: str, angles, target, weights, p, shape):
    """Gram-form cost ``xᵀGx − 2xᵀr`` of the linear parts of ``p`` at the
    shape values ``shape`` (the grid point, before the box clips it), in
    float64."""
    nl = MODELS[model].linear
    sums = _gram64(model, angles, target, weights, shape)
    x = p[:, :nl].double()
    if nl == 1:
        aa, ay = sums
        return x[:, 0] ** 2 * aa - 2 * x[:, 0] * ay
    aa, ab, bb, ay, by = sums
    kd, ks = x[:, 0], x[:, 1]
    return kd * kd * aa + ks * ks * bb + 2 * kd * ks * ab - 2 * (kd * ay + ks * by)


def _condition(model: str, angles, target, weights, shape):
    """κ of each texel's weighted Gram matrix at its shape values (1 for the
    lobes linear in one parameter)."""
    if MODELS[model].linear == 1:
        return torch.ones(shape.shape[0], dtype=torch.float64, device=shape.device)
    aa, ab, bb, _, _ = _gram64(model, angles, target, weights, shape)
    half = (aa + bb) / 2
    disc = torch.sqrt(torch.clamp(half * half - (aa * bb - ab * ab), min=0.0))
    return (half + disc) / torch.clamp(half - disc, min=1e-300)


def agreement(model: str, angles: ShadingAngles, target, grid, weights, got) -> dict:
    """Hold the kernel's starts ``got (T, n_params)`` on texel-major inputs
    to the plain version's. Returns the figures and ``failures``, the rules
    broken (empty where the kernel holds)."""
    nl = MODELS[model].linear
    want = grid_init.linear_grid_init_plain(model, angles, target, grid, weights)
    starts, costs = point_solves(model, angles, target, grid, weights)
    # a NaN cost never wins: the points within a tie of the least cost
    costs = torch.where(torch.isnan(costs), torch.inf, costs)
    best = costs.min(0).values
    near = costs <= best + TIE_RTOL * best.abs()
    finite = torch.isfinite(best)
    edge = ~finite | (costs == 0).all(0)
    decided = finite & (near.sum(0) == 1)

    # the kernel's start is one of the near points' starts: the same shape
    # values, the linear parts the nearest of theirs
    lin = (got[None, :, :nl] - starts[..., :nl]).abs().amax(-1).double()
    lin = lin / torch.clamp(starts[..., :nl].abs().amax(-1).double(), min=1e-300)
    match = near & (got[None, :, nl:] == starts[..., nl:]).all(-1)
    lin = torch.where(match, lin, torch.inf)
    rel, pick = lin.min(0)
    matched = torch.isfinite(rel)
    ref = starts.gather(0, pick[None, :, None].expand(1, *got.shape))[0]
    scored = ~edge

    kappa = _condition(model, angles, target, weights, got[:, nl:])
    bar = torch.clamp(16.0 * EPS32 * kappa, min=LINEAR_RTOL)
    well = bar <= LINEAR_CAP
    energy = (torch.ones_like(target) if weights is None else weights).double()
    energy = (energy * target.double() ** 2).sum(-1)
    point = _grid(model, grid, target)[pick]
    cost_gap = (_cost64(model, angles, target, weights, got, point)
                - _cost64(model, angles, target, weights, ref, point)).abs() / energy

    def top(x):
        return float(x.max()) if x.numel() else 0.0

    n = max(int(scored.sum()), 1)
    ks = kappa[scored]
    out = dict(
        lanes=target.shape[0],
        edge_lanes=int(edge.sum()),
        decided_share=float((decided & scored).sum()) / n,
        other_point_share=float((scored & ~(got[:, nl:] == want[:, nl:]).all(-1)).sum()) / n,
        ill_conditioned_share=float((scored & ~well).sum()) / n,
        kappa_quantiles=[float(q) for q in torch.quantile(
            ks.clamp(max=1e300), ks.new_tensor([0.5, 0.9, 0.99]))] if ks.numel() else [],
        kappa_max=top(ks),
        linear_rel_err=top(rel[scored & matched & well]),
        linear_err_over_bar=top((rel / bar)[scored & matched & well]),
        cost_rel_err=top(cost_gap[scored & matched]),
    )
    failures = []
    if not bool(matched[scored].all()):
        failures.append(f"{int((scored & ~matched).sum())} lanes start at no point that ties "
                        "with the least cost, or at its shape values with other linear parts")
    if not bool((got[decided & ~edge, nl:] == want[decided & ~edge, nl:]).all()):
        failures.append("another grid point on a decided lane")
    if not bool((rel <= bar)[scored & matched & well].all()):
        failures.append(f"linear parts {out['linear_err_over_bar']:.3g}× their bar")
    if not bool((cost_gap <= COST_RTOL)[scored & matched].all()):
        failures.append(f"costs {out['cost_rel_err']:.3g} of Σw·y² apart")
    if not torch.equal(got[edge], want[edge]):
        failures.append("NaN or all-zero lanes differ")
    out["failures"] = failures
    return out
