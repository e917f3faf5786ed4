"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``brdf_tpu_torch/csrc`` (one ``nvcc``
per source, in parallel), then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds kernel K1 (the fused VarPro solve, ``csrc/varpro.cu``) against its
   plain PyTorch version on the card, on ``bench.py::make_problem``'s
   distribution (seed 0): blinn_phong and cook_torrance at T=131072,
   phong and ward at T=16384, V=16, each without and with a start ``p0``
   and without and with a weight mask on 4 views;
3. checks the bench row's quality gates (blinn_phong, k=6, grid 8):
   recovery ≥ 0.97 and χ² p99 ≤ 1e-6;
4. drives the port's main path, ``fit_per_texel``, on 131072 texels × 3
   channels × 16 views with the timber-blinn and bunny-ct solver settings,
   counts K1's launches (1 + robust_iters per fit) and holds the result
   against the same pipeline run through the plain version on the card;
5. times K1 and its plain version with CUDA events, and the warm main path
   (host clock; device time by kernel from ``torch.profiler``);
6. prints one JSON line of every ported kernel, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and the script exits non-zero without the ``ok`` line.
It needs the repository beside it and a CUDA device; it imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles  # noqa: E402
from brdf_tpu_torch.ops import _build, varpro as k1  # noqa: E402
from brdf_tpu_torch.parallel import fit as pfit  # noqa: E402
from brdf_tpu_torch.pipeline.fit import TexelProblem, fit_per_texel  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402

T_BENCH, V = 131072, 16
T_SMALL = 16384
CHANNELS = 3
# parity bar between K1 and its plain version on the card: the two round
# alike operation for operation (csrc/lobes.cuh), so all but a few lanes
# must agree; 1e-4 relative with a 1e-3 floor on |param|
PARITY_RTOL, PARITY_SHARE = 1e-4, 0.999
# H100 SXM: HBM3 bandwidth and FP32 (non-tensor) peak, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (view, texel) of K1, counted from csrc/lobes.cuh and
# csrc/varpro.cu (each add, multiply, compare-select, divide, exp, log and
# sqrt counted as one): one lobe evaluation with its shape derivative, the
# grid pass's accumulation, the Newton pass 1 and pass 2 accumulations
LOBE_OPS = {"blinn_phong": 10, "phong": 16, "cook_torrance": 48, "ward": 24}
GRID_ACC_OPS, NEWTON_ACC_OPS, RESID_OPS = 7, 15, 8
PER_TEXEL_SOLVE_OPS = 80          # _bvls2 and the scalar Newton update
DEVICE = torch.device("cuda")


def check(ok, what) -> None:
    """Fail the run (not an ``assert``: it must hold under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def make_problem(rng: np.random.Generator, t: int, v: int, model: str):
    """The port's copy of bench.py::make_problem: random angles and targets
    from known parameters (roughness lobes draw σ in [0.15, 0.9], as
    tests/test_varpro.py does)."""
    cols = dict(
        cos_ln=rng.uniform(0.0, 1.0, (t, v)),
        cos_nh=rng.uniform(0.0, 1.0, (t, v)),
        cos_rv=rng.uniform(-1.0, 1.0, (t, v)),
        cos_vn=rng.uniform(0.1, 1.0, (t, v)),
    )
    shape = rng.uniform(2.0, 30.0, t) if "phong" in model else rng.uniform(0.15, 0.9, t)
    true_p = np.stack([rng.uniform(0.1, 0.9, t), rng.uniform(0.2, 1.0, t), shape], -1)
    ang = ShadingAngles(**{k: torch.tensor(x, dtype=torch.float32, device=DEVICE)
                           for k, x in cols.items()})
    p = torch.tensor(true_p, dtype=torch.float32, device=DEVICE)
    with torch.no_grad():
        target = MODELS[model].fn(p, ang)
    return ang, target, true_p.astype(np.float32)


def agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    rel = (a - b).abs() / b.abs().clamp(min=1e-3)
    return float((rel.amax(-1) < PARITY_RTOL).double().mean())


def recovery(p: np.ndarray, true_p: np.ndarray) -> float:
    rel = (np.abs(p - true_p) / np.maximum(np.abs(true_p), 1e-3)).max(-1)
    return float((rel < 1e-2).mean())


def k1_operations(model: str, t: int, v: int, n_grid: int, iters: int, with_p0: bool) -> float:
    """FP32 operations K1 does on these inputs (fixed work: no lane stops early)."""
    lobe = LOBE_OPS[model]
    grid = 0 if with_p0 else n_grid * (lobe + GRID_ACC_OPS)
    newton = (iters + 1) * (lobe + NEWTON_ACC_OPS + RESID_OPS)
    staging = lobe + 4
    return float(t) * (v * (staging + grid + newton) + PER_TEXEL_SOLVE_OPS * (n_grid + iters + 1))


def k1_bytes(n_angles: int, t: int, v: int, with_p0: bool) -> float:
    """Each input read once, each output written once."""
    return 4.0 * t * ((n_angles + 2) * v + (1 if with_p0 else 0) + 8)


def cuda_ms(fn, reps: int) -> float:
    """Device time per call: a run of ``reps`` back-to-back calls between two
    CUDA events, divided by ``reps`` (so host launch overhead overlaps the
    kernels instead of adding idle time); median of 3 runs, after two
    warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return float(np.median(runs))


def phase_parity(errs: list[float]) -> dict:
    """K1 against its plain version on identical inputs on the card."""
    rng = np.random.default_rng(0)
    cases = {}
    for model, t in (("blinn_phong", T_BENCH), ("cook_torrance", T_BENCH),
                     ("phong", T_SMALL), ("ward", T_SMALL)):
        ang, target, true_p = make_problem(rng, t, V, model)
        cfg = k1.config(model)
        mask = torch.ones_like(target)
        mask[:, torch.randperm(V, generator=torch.Generator().manual_seed(1))[:4]] = 0.0
        p0 = torch.tensor(true_p * rng.uniform(0.8, 1.2, true_p.shape), dtype=torch.float32,
                          device=DEVICE)
        for with_p0 in (False, True):
            for masked in (False, True):
                inputs = k1.stack_inputs(model, ang, target, mask if masked else None,
                                         p0 if with_p0 else None)
                out_k = k1.varpro_rows_cuda(cfg, *inputs, iters=6)
                torch.cuda.synchronize()
                out_p = k1.varpro_rows_plain(cfg, *inputs, iters=6)
                torch.cuda.synchronize()
                check(torch.isfinite(out_k).all(), f"{model}: non-finite K1 output")
                pk, pp = out_k[:3].T, out_p[:3].T
                share = agreement(pk, pp)
                stop_share = float((out_k[5] == out_p[5]).double().mean())
                err = float((out_k[:4] - out_p[:4]).abs().max())
                errs.append(err)
                name = f"{model}/T={t}/p0={int(with_p0)}/mask={int(masked)}"
                cases[name] = dict(param_share=share, stop_share=stop_share, max_abs_err=err)
                log(f"parity {name}: params {share:.6f} stop {stop_share:.6f} max|d| {err:.3g}")
                check(share >= PARITY_SHARE, f"K1 vs plain params agree on {share} of lanes ({name})")
                check(stop_share >= PARITY_SHARE,
                      f"K1 vs plain stop codes agree on {stop_share} ({name})")
    return cases


def phase_gates() -> tuple[dict, tuple]:
    """bench.py::_check_gates on the bench row, through K1."""
    ang, target, true_p = make_problem(np.random.default_rng(0), T_BENCH, V, "blinn_phong")
    r = k1.varpro_fit_fused("blinn_phong", ang, target, iters=6, grid_points=8)
    torch.cuda.synchronize()
    p = r.p.cpu().numpy()
    chi2 = r.chi2.cpu().numpy()
    gates = dict(recovery_frac=recovery(p, true_p), chi2_median=float(np.median(chi2)),
                 chi2_p99=float(np.percentile(chi2, 99)))
    log(f"bench row gates: {gates}")
    check(np.isfinite(p).all() and p.shape == (T_BENCH, 3), "bench row: finite (T, 3) parameters")
    check(gates["recovery_frac"] >= 0.97, gates)
    check(gates["chi2_p99"] <= 1e-6, gates)
    return gates, (ang, target)


def _texel_problem(model: str, seed: int):
    rng = np.random.default_rng(seed)
    ang, _, _ = make_problem(rng, T_BENCH, V, model)
    true_p, inten = [], []
    for _ in range(CHANNELS):
        shape = rng.uniform(2.0, 30.0, T_BENCH) if "phong" in model else rng.uniform(0.15, 0.9, T_BENCH)
        p = np.stack([rng.uniform(0.1, 0.9, T_BENCH), rng.uniform(0.2, 1.0, T_BENCH), shape], -1)
        true_p.append(p)
        with torch.no_grad():
            inten.append(MODELS[model].fn(torch.tensor(p, dtype=torch.float32, device=DEVICE), ang))
    problem = TexelProblem(angles=ang, intensity=torch.stack(inten, -1),
                           weights=torch.ones(T_BENCH, V, device=DEVICE),
                           face_ids=np.arange(T_BENCH))
    return problem, np.stack(true_p, 1).astype(np.float32)


def _plain_fused(model, angles, target, weights=None, p0=None, iters=6, lower=None,
                 upper=None, grid_points=8):
    """varpro_fit_fused with K1's plain version in place of the kernel, on
    the card: the reference the main path is held against."""
    cfg = k1.config(model, lower, upper, grid_points)
    ang, y, w, sig0 = k1.stack_inputs(model, angles, target, weights, p0)
    return k1.rows_to_result(k1.varpro_rows_plain(cfg, ang, y, w, sig0, iters))


MAIN_PATH = {
    # solver settings of the timber-blinn and bunny-ct presets
    # (brdf_tpu/configs.py): SolverConfig defaults itmax=60 (k=16) and
    # robust_iters=2
    "timber-blinn": dict(model="blinn_phong", robust="huber", robust_iters=2,
                         lower=None, upper=None),
    "bunny-ct": dict(model="cook_torrance", robust="huber", robust_iters=2,
                     lower=[0.0, 0.0, 1e-3], upper=[2.0, 2.0, 1.0]),
}


OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=60)


def _fit(problem, cfg):
    return fit_per_texel(problem, cfg["model"], opts=OPTS, device="cuda", engine="varpro",
                         robust=cfg["robust"], robust_iters=cfg["robust_iters"],
                         lower=cfg["lower"], upper=cfg["upper"])


def phase_main_path(errs: list[float]) -> tuple[int, dict, dict]:
    problems = {name: _texel_problem(cfg["model"], seed=i + 1)
                for i, (name, cfg) in enumerate(MAIN_PATH.items())}
    torch.cuda.synchronize()
    reports, counts = {}, {}
    k1.LAUNCHES = 0                              # the main path starts here
    for name, cfg in MAIN_PATH.items():
        before = k1.LAUNCHES
        t0 = time.perf_counter()
        rep = _fit(problems[name][0], cfg)
        torch.cuda.synchronize()
        reports[name] = (rep, time.perf_counter() - t0)
        counts[name] = k1.LAUNCHES - before
    launches = k1.LAUNCHES                       # ... and ends here
    out = {}
    for name, cfg in MAIN_PATH.items():
        rep, secs = reports[name]
        check(counts[name] == 1 + cfg["robust_iters"],
              f"{name}: K1 launched {counts[name]} times, expected {1 + cfg['robust_iters']}")
        with mock.patch.object(pfit, "varpro_fit_fused", _plain_fused):
            ref = _fit(problems[name][0], cfg)
        torch.cuda.synchronize()
        p, pr = rep.params.reshape(-1, 3), ref.params.reshape(-1, 3)
        check(rep.params.shape == (T_BENCH, CHANNELS, 3), f"{name}: parameters of shape (T, C, 3)")
        check(torch.isfinite(rep.params).all() and torch.isfinite(rep.result.chi2).all(),
              f"{name}: finite parameters and chi2")
        share = agreement(p, pr)
        err = float((p - pr).abs().max())
        errs.append(err)
        rec = recovery(p.cpu().numpy(), problems[name][1].reshape(-1, 3))
        out[name] = dict(launches=counts[name], fits=T_BENCH * CHANNELS, first_wall_s=secs,
                         param_share=share, max_abs_err=err, recovery_frac=rec,
                         chi2_median=float(rep.result.chi2.median()))
        log(f"main path {name}: {out[name]}")
        check(share >= PARITY_SHARE, f"{name}: kernel path vs plain path agree on {share}")
    return launches, out, {name: prob for name, (prob, _) in problems.items()}


def phase_breakdown(problems: dict) -> dict:
    """Warm ``fit_per_texel`` wall time (median of 3, host clock around a
    synchronised call) and, from ``torch.profiler``, the device time of one
    warm fit by kernel: where the main path's time goes."""
    from torch.profiler import ProfilerActivity, profile

    saved = k1.LAUNCHES
    out = {}
    for name, cfg in MAIN_PATH.items():
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _fit(problems[name], cfg)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _fit(problems[name], cfg)
            torch.cuda.synchronize()
        kernels = sorted(
            ((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
            reverse=True)
        busy_ms = sum(k[0] for k in kernels) / 1e3
        k1_ms = sum(k[0] for k in kernels if "varpro_kernel" in k[1]) / 1e3
        wall = float(np.median(walls))
        out[name] = dict(
            wall_ms_median=wall, wall_ms=walls, device_busy_ms=busy_ms, k1_device_ms=k1_ms,
            device_idle_share=1.0 - busy_ms / wall if busy_ms else None,
            top_kernels=[dict(name=k[:90], device_ms=us / 1e3, count=c)
                         for us, k, c in kernels[:8]])
        log(f"breakdown {name}: wall {wall:.3f} ms, device busy {busy_ms:.3f} ms, K1 {k1_ms:.3f} ms")
    k1.LAUNCHES = saved                          # these launches are not the main path's
    return out


def phase_timing(bench_inputs) -> dict:
    """K1 and its plain version at the bench row and at one main-path call
    (timber-blinn round 0: 393216 lanes, k=16, weights)."""
    ang_b, target_b = bench_inputs
    cfg_b = k1.config("blinn_phong")
    in_b = k1.stack_inputs("blinn_phong", ang_b, target_b)
    problem, _ = _texel_problem("blinn_phong", seed=1)
    ang_m = ShadingAngles(*(a.repeat_interleave(CHANNELS, 0) for a in problem.angles[:4]))
    y_m = problem.intensity.permute(0, 2, 1).reshape(-1, V)
    w_m = (y_m < 0.98).float()
    in_m = k1.stack_inputs("blinn_phong", ang_m, y_m, w_m)
    saved = k1.LAUNCHES
    res = {}
    for key, inputs, iters in (("bench", in_b, 6), ("main", in_m, 16)):
        t = inputs[0].shape[-1]
        ms = cuda_ms(lambda: k1.varpro_rows_cuda(cfg_b, *inputs, iters=iters), reps=20)
        plain_ms = cuda_ms(lambda: k1.varpro_rows_plain(cfg_b, *inputs, iters=iters), reps=2)
        ops = k1_operations("blinn_phong", t, V, len(cfg_b.grid_sig), iters, False)
        nbytes = k1_bytes(2, t, V, False)
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
        bound_by = max(bound, key=bound.get)
        res[key] = dict(texels=t, iters=iters, ms=ms, plain_ms=plain_ms,
                        fits_per_s=t / (ms * 1e-3), bytes=nbytes, operations=ops,
                        bound_ms=bound[bound_by], bound_by=bound_by)
    k1.LAUNCHES = saved                          # timing launches are not the main path's
    return res


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")

    errs_parity: list[float] = []
    parity = phase_parity(errs_parity)
    gates, bench_inputs = phase_gates()
    errs_main: list[float] = []
    launches, main_path, problems = phase_main_path(errs_main)
    check(launches > 0, "the main path never launched K1")
    timing = phase_timing(bench_inputs)
    breakdown = phase_breakdown(problems)

    print(json.dumps({
        "numbers": {
            "card": card, "kernel": "K1 varpro (csrc/varpro.cu)",
            "bench_row": dict(timing["bench"], model="blinn_phong", grid=8, **gates),
            "main_path_call": dict(timing["main"], model="blinn_phong"),
            "main_path": main_path, "main_path_warm": breakdown, "parity": parity,
        }
    }))
    main_t = timing["main"]
    print(json.dumps({"kernels": [{
        "name": "varpro_k1",
        "route": "cuda",
        "source": "brdf_tpu_torch/csrc/varpro.cu",
        "replaces": "brdf_tpu/ops/varpro_pallas.py:47",
        "launches": launches,
        "max_abs_err": max(errs_parity + errs_main),
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
