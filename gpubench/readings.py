"""Readings that the check's limits are set from, on the card: the program's
compared numbers over many seeds, the control's (the reference in the
program's place, in bfloat16) and each planted fault's (``faults.py``).

    python3 gpubench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control 3] [--faults 3] [--seconds 3] [--out chiprun_out/readings.jsonl]

Per seed: the cell's set-up, a short window of its own traffic, then the
check of the sampled requests with their details (on the first seed of a fit
cell also where the program's answers are worse than the reference's: the
solver's stop reasons there); on the first ``--control``
seeds also the control's numbers for the same requests, and on the first
``--faults`` seeds each fault's numbers for two requests made with it
planted. One JSON line a seed goes to ``--out`` and to standard output.
The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import os  # noqa: E402

os.environ["BRDF_TPU_TORCH_CACHE_DIR"] = ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from gpubench import core, faults

    cell = core.find_cell(core.load_manifest(), args.workload)
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        entry = core.entry_module(cell).Entry(cell, seed, device)
        entry.setup()
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 3]))
        w = core.closed_loop(entry.request, args.seconds, int(cell.traffic["check"]["sample"]), rng)
        planted = {}
        if i < args.faults:
            for fault in faults.FAULTS:
                with faults.planted(cell.traffic["entry"], fault):
                    recs = [entry.request(10**6 + j)[1] for j in range(2)]
                planted[fault] = recs[-1:]
        diag = None
        if i == 0 and hasattr(entry, "diagnose"):
            diag = (0,) + tuple(entry.fit(entry.problems[0], extra=True))
        entry.release()
        row = {"workload": args.workload, "seed": seed, "setup_s": setup_s,
               "requests": len(w.times), "window_s": w.seconds,
               "p50_ms": core.percentile(w.times, 50) * 1e3,
               "p95_ms": core.percentile(w.times, 95) * 1e3,
               "program": entry.judge(w.samples, detail=True)}
        if i < args.control:
            row["control"] = entry.judge(w.samples, answers=entry.control, detail=True)
        if diag is not None:
            row["diagnosis"] = entry.diagnose(*diag)
        for fault, recs in planted.items():
            row["fault_" + fault] = entry.judge(recs)
        row["check_s"] = time.perf_counter() - t0 - setup_s - w.seconds
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del entry
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
