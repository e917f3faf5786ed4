# Adapted from brdf_tpu/utils/logging.py (the port imports nothing of brdf_tpu).
"""Structured logging / observability.

The reference logged progress via scattered ``std::cout`` and an on-screen
HUD (``brdfdata.cpp:1063-1064``, ``glutcallbacks.cpp:530-605``). Here:
structured JSONL events (residual norms, convergence histograms, throughput),
tee'd to stdout, from rank 0 only (``torch.distributed``; a single process is
rank 0), as the JAX package writes from process 0.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from brdf_tpu_torch.parallel.mesh import process_index


def _now() -> float:
    return time.time()


def log_event(kind: str, quiet: bool = False, **fields) -> dict:
    """Emit one structured event to stdout (rank 0 only). Returns it."""
    event = {"t": round(_now(), 3), "kind": kind, **fields}
    if process_index() == 0 and not quiet:
        print(json.dumps(event, default=_np_default), file=sys.stdout, flush=True)
    return event


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    raise TypeError(type(o))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fit_summary_event(result, quiet: bool = False) -> dict:
    """Convergence/diagnostic summary of an LMResult batch — the vectorized
    analogue of levmar's per-fit info[] printout (``brdfdata.cpp:1063``)."""
    chi2 = _host(result.chi2)
    stop = _host(result.stop)
    iters = _host(result.iters)
    reasons, counts = np.unique(stop, return_counts=True)
    return log_event(
        "fit_summary",
        quiet=quiet,
        n=int(chi2.size),
        chi2_median=float(np.median(chi2)),
        chi2_p90=float(np.percentile(chi2, 90)),
        chi2_max=float(chi2.max()),
        iters_median=float(np.median(iters)),
        converged_frac=float(np.isin(stop, (1, 2, 6)).mean()),
        stop_counts={int(r): int(c) for r, c in zip(reasons, counts)},
    )


class EventLog:
    """JSONL event sink (plus stdout): one file per run, append-only."""

    def __init__(self, path: str | None):
        self.path = path
        if path and process_index() == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def __call__(self, kind: str, **fields):
        event = log_event(kind, **fields)
        if self._fh:
            self._fh.write(json.dumps(event, default=_np_default) + "\n")
        return event

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
