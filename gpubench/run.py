"""Run one cell of the benchmark once on this machine's GPU.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration (``gpubench/configs/<config>.json``) and its traffic
(``gpubench/workloads/<cell>.json``), whose ``entry`` names the entry kind
(``gpubench/entries/<entry>.py``). Set-up makes the scans from the seed and
warms every shape the traffic uses; then one caller sends requests for
``--seconds`` (a closed loop). With ``--trace 1`` a bounded number of
further requests run under ``torch.profiler`` and the cell's per-layer
metrics (``gpubench/metrics/<metric>.py``) are read from that trace;
with ``--trace 0`` its end-to-end metrics are read from the window. Once the
window has closed, the sampled requests are checked against the plain
reference (``gpubench/reference/``), each compared number printed beside its
limit on standard error and in the result line; the last line of standard
output is the result as one JSON object.

Exit codes: 0 with a result; 2 on bad arguments; 3 without enough CUDA
devices; 4 when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout; the raster
# cache's disk tier off, so no run reads what another run wrote
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "gpubench_cache" / sub)
os.environ["BRDF_TPU_TORCH_CACHE_DIR"] = ""
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: object
    entry: object
    setup_s: float
    window: object = None
    trace: object = None


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def read_metrics(defs: list, run: Run, here: Path) -> dict:
    from gpubench import core

    out = {}
    for m in defs:
        value = core.metric_module(m["name"], here).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpubench import core

    cell = core.find_cell(core.load_manifest(), args.workload)
    import numpy as np
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    entry = core.entry_module(cell).Entry(cell, args.seed, device)
    log(f"{args.workload}: set-up")
    entry.setup()
    torch.cuda.synchronize(device)
    gc.collect()
    run = Run(cell, entry, time.perf_counter() - T0)
    log(f"set-up {run.setup_s:.3f} s; window of {args.seconds} s")

    check = cell.traffic["check"]
    rng = np.random.default_rng(np.random.SeedSequence([args.seed % 2**63, 3]))
    run.window = core.closed_loop(entry.request, args.seconds, int(check["sample"]), rng)
    e2e = read_metrics(cell.end_to_end, run, core.HERE)
    log(f"window: {len(run.window.times)} requests in {run.window.seconds:.3f} s; "
        + ", ".join(f"{k} {v['value']:.6g}" for k, v in e2e.items()))
    if args.trace:
        from gpubench.trace import Tracer, capture

        tracer = Tracer()
        for m in cell.per_layer:
            reader = core.metric_module(m["name"])
            if hasattr(reader, "install"):
                reader.install(tracer)
        run.trace = capture(entry.request, len(run.window.times), int(cell.traffic["trace_calls"]),
                            device, tracer)
        for label, (seen, counted) in run.trace.launch_check.items():
            log(f"launch check {label}: {seen} in the trace, {counted} counted by the program"
                + ("" if seen == counted else "  MISMATCH"))
        log(f"trace: {run.trace.calls} requests, span {run.trace.span_s:.4f} s, "
            f"busy {run.trace.busy_s:.4f} s")
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    metrics = read_metrics(cell.per_layer, run, core.HERE) if args.trace else e2e

    found = core.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 4

    # the check: after the window, with the peak read and the program's state freed
    entry.release()
    gc.collect()
    torch.cuda.empty_cache()
    log("check against the reference")
    numbers = entry.judge(run.window.samples)
    limits = check["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                   "memory_peak_bytes": int(peak), "power_limit": power_limit()}
    result = {"correct": correct, "attempted": len(run.window.times), "failed": 0,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.span_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
