"""The bar the joint LM kernel (``csrc/joint_levmar.cu``) is held to against
its plain version (``ops/joint_levmar.py::joint_levmar_plain``) on the same
CUDA inputs, and a run of it on the timber joint cell's scan, shared by
``chip_smoke.py``'s joint LM phase.

    python3 tools/joint_levmar_agreement.py [--seed N] [--out FILE]

The two solve the same problem in float32 by the same algorithm, but the
kernel sums a face's views in its lane group's order and factors in its own
Cholesky, so a face's path can part from the plain version's at the last bit
(both are ``levmar_bc``; the forward-mode solve parts from the plain version
as often). The numbers, over the faces:

- ``same_stop_share``: the share with the same stop code, and
  ``same_path_share`` with the same stop code and iterations;
- ``chi2_rel_median`` and ``chi2_rel_p99`` of |χ²_kernel − χ²_plain| ÷
  χ²_plain;
- ``kernel_worse_share``: the share whose χ² ends more than 1e-4 above the
  plain version's (relative), and ``plain_worse_share`` the reverse.

And the kernel's answers against the model itself: ``chi2_sum_gap``, the
gap between the χ² the kernel reports and the χ² that
``models/normalmap.py::joint_eval`` gives its parameters, summed over the
faces (relative), and ``chi2_consistent_share``, the share of faces whose two
agree to 1e-4 (relative, or 1e-10). The lobe jumps where a cosine crosses 0,
the fit drives some faces onto that edge, and there the two sides of the
edge differ by a whole lobe: a fit whose χ² belongs to another function than
the model's shows here first, and its gains go wrong after it.

The bars on a solve (``held``): a median |Δχ²| / χ² of at most
:data:`MEDIAN_BAR`, a tail: the kernel worse than the plain version on at
most :data:`TAIL_BAR` more of the faces than the reverse, and the kernel's
χ² the model's: ``chi2_sum_gap`` at most :data:`SUM_GAP_BAR` and
``chi2_consistent_share`` at least :data:`CONSISTENT_BAR`. The same-stop
share is read against :data:`SAME_STOP_BAR` (``same_stop_held``) and beside
the eager solve's own share, and not held to it: float32 rounding alone
moves a tenth of the faces to another stop code (the eager solve against the
plain version reads 0.88–0.91 on the card), so the bar would part correct
solves by chance, where the tail bar does not. Beside them, as the yardstick of how far float32 rounding
alone parts two correct solves, ``eager_same_stop_share`` and
``eager_chi2_rel_median``: the eager forward-mode ``levmar_bc`` (the path the
kernel replaced) against the same plain version, on the same inputs.

The run takes the first solve of ``fit_joint_normalmap`` as the
``timber-joint-aniso-16led`` configuration makes it (the upload, the
saturation mask, one grid init of the three channels, the joint start) on
one scan of ``gpubench/traffic/scan_joint_aniso.py``, at its 16 views and at
its first :data:`RAGGED_VIEWS` (not a multiple of the kernel's lanes a face).
Then the whole gain alternation (``fit_joint_normalmap_with_gains``, the
configuration's rounds) twice on that scan: as the main path runs it (each
kernel solve held to the model), and with the plain version in the kernel's
place, the kernel run beside it on each of its solves' inputs (each round's
solve bars as above). The
alternation's bar: the two paths' rig gains within :data:`GAIN_BAR` of each
other (``gain_gap``, the largest |g_kernel − g_plain| ÷ g_plain), which is
where a kernel that is wrong on some faces shows first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from brdf_tpu_torch.models.brdf import ShadingAngles, ShadingGeometry  # noqa: E402
from brdf_tpu_torch.models.normalmap import (  # noqa: E402
    joint_eval,
    joint_p0_from_channelwise,
    joint_residual,
    joint_spec,
)
from brdf_tpu_torch.ops import joint_levmar  # noqa: E402
from brdf_tpu_torch.solver.init import linear_grid_init  # noqa: E402
from brdf_tpu_torch.solver.lm import levmar_bc  # noqa: E402
from brdf_tpu_torch.solver.robust import saturation_weights  # noqa: E402

MEDIAN_BAR = 1e-4
SAME_STOP_BAR = 0.9
TAIL_BAR = 0.02
GAIN_BAR = 0.02
SUM_GAP_BAR = 1e-3
CONSISTENT_BAR = 0.999
WORSE_RTOL = 1e-4
RAGGED_VIEWS = 13
CELL = "timber-joint-aniso-16led.fit"


def agreement(kernel, plain) -> dict:
    """The numbers above for two ``LMResult``s of the same faces, and whether
    they pass the bars (``held``)."""
    same_stop = kernel.stop == plain.stop
    rel = (kernel.chi2.double() - plain.chi2.double()).abs() / plain.chi2.double().clamp(min=1e-30)
    out = dict(
        faces=int(plain.chi2.numel()),
        same_stop_share=same_stop.double().mean().item(),
        same_path_share=(same_stop & (kernel.iters == plain.iters)).double().mean().item(),
        chi2_rel_median=rel.median().item(),
        chi2_rel_p99=torch.quantile(rel, 0.99).item(),
        kernel_worse_share=(kernel.chi2.double() > plain.chi2.double() * (1 + WORSE_RTOL))
        .double().mean().item(),
        plain_worse_share=(plain.chi2.double() > kernel.chi2.double() * (1 + WORSE_RTOL))
        .double().mean().item(),
        stops_kernel=torch.bincount(kernel.stop.long().cpu(), minlength=8).tolist(),
        stops_plain=torch.bincount(plain.stop.long().cpu(), minlength=8).tolist(),
    )
    out["same_stop_held"] = out["same_stop_share"] >= SAME_STOP_BAR
    out["held"] = (out["chi2_rel_median"] <= MEDIAN_BAR
                   and out["kernel_worse_share"] <= out["plain_worse_share"] + TAIL_BAR)
    return out


def consistency(spec, res, geometry, target, weights) -> dict:
    """The kernel's reported χ² against the model's at its parameters
    (``joint_eval`` on the same inputs), and whether they pass their bars."""
    e = (joint_eval(spec, res.p, geometry) - target) * weights
    model = (e.double() ** 2).sum((1, 2))
    got = res.chi2.double()
    gap = abs(got.sum().item() - model.sum().item()) / max(model.sum().item(), 1e-30)
    share = ((got - model).abs() <= 1e-4 * model + 1e-10).double().mean().item()
    return dict(chi2_sum_gap=gap, chi2_consistent_share=share,
                consistent=gap <= SUM_GAP_BAR and share >= CONSISTENT_BAR)


def solve_inputs(problem, base_model: str, max_tilt: float, device):
    """The first joint solve's inputs as ``pipeline/fit.py::fit_joint_normalmap``
    makes them → ``(spec, geometry, intensity, p0, weights)``."""
    spec = joint_spec(base_model, max_tilt=max_tilt)
    intensity = torch.as_tensor(problem.intensity).to(device)
    geometry = ShadingGeometry(*(torch.as_tensor(x).to(device) for x in problem.geometry))
    angles = ShadingAngles(*(None if a is None else torch.as_tensor(a).to(device)[:, None]
                             for a in problem.angles))
    w = torch.as_tensor(problem.weights).to(device=device, dtype=intensity.dtype)
    weights = w[..., None].repeat(1, 1, 3) * saturation_weights(intensity)
    chan = linear_grid_init(base_model, angles, intensity.transpose(1, 2).contiguous(),
                            weights=weights.transpose(1, 2).contiguous())
    return spec, geometry, intensity, joint_p0_from_channelwise(chan), weights


def first_views(problem, v: int):
    """``problem`` with its first ``v`` views."""
    geom = problem.geometry
    return problem._replace(
        angles=ShadingAngles(*(None if a is None else a[:, :v] for a in problem.angles)),
        intensity=problem.intensity[:, :v], weights=problem.weights[:, :v],
        geometry=ShadingGeometry(geom.n, geom.l[:, :v], geom.v[:, :v]))


def repeat_views(problem, times: int):
    """``problem`` with its views ``times`` over, one after another (each
    copy a view of its own, with its own gain): more views a face than the
    scan's rig has."""
    geom = problem.geometry

    def rep(x):
        return None if x is None else torch.as_tensor(x).repeat(1, times, *([1] * (x.ndim - 2)))

    return problem._replace(
        angles=ShadingAngles(*(rep(a) for a in problem.angles)),
        intensity=rep(problem.intensity), weights=rep(problem.weights),
        geometry=ShadingGeometry(geom.n, rep(geom.l), rep(geom.v)))


def compare(problem, config: dict, device) -> dict:
    """The kernel and its plain version on the first solve of ``problem``,
    each timed on the host clock up to a synchronisation."""
    from gpubench import program

    spec, geometry, intensity, p0, weights = solve_inputs(problem, config["model"],
                                                          config["max_tilt"], device)
    opts = program.lm_options(config)
    def eager(spec, geometry, intensity, p0, weights, opts):
        return levmar_bc(joint_residual(spec), p0, spec.lower, spec.upper,
                         data=(geometry, intensity, weights), opts=opts)

    timed = {}
    for name, fn in (("kernel", joint_levmar.joint_levmar),
                     ("plain", joint_levmar.joint_levmar_plain), ("eager", eager)):
        t0 = time.perf_counter()
        timed[name] = fn(spec, geometry, intensity, p0, weights, opts)
        torch.cuda.synchronize(device)
        timed[name + "_s"] = time.perf_counter() - t0
    out = agreement(timed["kernel"], timed["plain"])
    out.update(consistency(spec, timed["kernel"], geometry, intensity, weights))
    out["held"] = out["held"] and out["consistent"]
    yardstick = agreement(timed["eager"], timed["plain"])
    out.update(eager_same_stop_share=yardstick["same_stop_share"],
               eager_chi2_rel_median=yardstick["chi2_rel_median"],
               views=int(intensity.shape[1]), lanes=joint_levmar.lane_layout(intensity.shape[1]),
               kernel_s=timed["kernel_s"], plain_s=timed["plain_s"], eager_s=timed["eager_s"])
    return out


@contextlib.contextmanager
def kernel_solves(rounds: list, plain: bool):
    """The main path, each of its kernel solves checked against the model
    (:func:`consistency`, appended to ``rounds``); with ``plain`` the plain
    version answers in the kernel's place, and the kernel's row beside it on
    the same inputs adds :func:`agreement` with the plain version."""
    kernel = joint_levmar.joint_levmar

    def solve(spec, geometry, target, p0, weights, opts):
        got = kernel(spec, geometry, target, p0, weights, opts)
        row = consistency(spec, got, geometry, target, weights)
        row["held"] = row["consistent"]
        if plain:
            answer = joint_levmar.joint_levmar_plain(spec, geometry, target, p0, weights, opts)
            row.update(agreement(got, answer))
            row["held"] = row["held"] and row["consistent"]
        rounds.append(row)
        return answer if plain else got

    joint_levmar.joint_levmar = solve
    try:
        yield
    finally:
        joint_levmar.joint_levmar = kernel


def alternation(problem, config: dict, device) -> dict:
    """The configuration's gain alternation on ``problem`` by the main path
    (the kernel) and by the plain version in its place: their gains and the
    kernel against the plain version on each of the plain path's solves."""
    from brdf_tpu_torch.pipeline.fit import fit_joint_normalmap_with_gains
    from gpubench import program

    s = config["solver"]

    def fit():
        launches = joint_levmar.LAUNCHES
        res, _, gains = fit_joint_normalmap_with_gains(
            problem, config["model"], rounds=s["view_gain_rounds"],
            mask_saturation=s["mask_saturation"], opts=program.lm_options(config),
            max_tilt=config["max_tilt"], engine=s["engine"], device=device, robust=s["robust"],
            robust_iters=s["robust_iters"])
        return res, torch.as_tensor(gains, dtype=torch.float64), joint_levmar.LAUNCHES - launches

    main, rounds = [], []
    with kernel_solves(main, plain=False):
        _, g_kernel, launched = fit()
    with kernel_solves(rounds, plain=True):
        _, g_plain, _ = fit()
    gap = ((g_kernel - g_plain).abs() / g_plain).max().item()
    return dict(views=int(problem.intensity.shape[1]), kernel_solves=launched, gain_gap=gap,
                gains_kernel=g_kernel.tolist(), gains_plain=g_plain.tolist(), main=main,
                rounds=rounds, held=launched == len(main) == len(rounds) and gap <= GAIN_BAR
                and all(r["held"] for r in main + rounds))


def cell_problem(seed: int, device, index: int = 0):
    """The timber joint cell's configuration and the face problem of its
    scan ``seed`` (``index`` in its pool), as the cell's entry builds it."""
    from brdf_tpu_torch.pipeline.fit import build_face_problem
    from gpubench import core, program
    from gpubench.traffic.scan_joint_aniso import make_scan

    config = core.find_cell(core.load_manifest(), CELL).config
    problem = build_face_problem(program.scene(make_scan(config, seed, index, device=device)),
                                 with_geometry=True, tangent_frame=True,
                                 shadow_weights=config["solver"]["shadow_weights"])
    return problem, config


def run(problem, config: dict, device) -> dict:
    """The kernel against its plain version on ``problem``'s first solve at
    its own views and at its first :data:`RAGGED_VIEWS`, and over its whole
    gain alternation, each against the bars."""
    v = problem.intensity.shape[1]
    return {f"v{v}": compare(problem, config, device),
            f"v{RAGGED_VIEWS}": compare(first_views(problem, RAGGED_VIEWS), config, device),
            "alternation": alternation(problem, config, device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2400000001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("joint_levmar_agreement: no CUDA device", file=sys.stderr)
        return 1
    from brdf_tpu_torch.ops import _build

    _build.build_all()
    device = torch.device("cuda")
    res = run(*cell_problem(args.seed, device), device)
    line = json.dumps(dict(seed=args.seed, card=torch.cuda.get_device_name(0), **res))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if all(r["held"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
