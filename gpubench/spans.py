"""The program's own spans and counters (``brdf_tpu_torch/utils/profiling.py``,
and the eager LM loop's ``ops/ne.py::LOOP_SYNCS``) for the per-layer metrics
that read them.

``install`` turns the program's recording on and clears it just before the
traced requests (the timed window runs with it off) and notes the sync
counter in the tracer's records. The readers divide by the traced requests
and return None where the program has no recorder or recorded nothing there.
Span times are host wall time on the profiler's clock, so they can be set
against ``Trace.kernels``."""

from __future__ import annotations

import bisect
import importlib

SYNCS = "loop_syncs_before"


def _profiling():
    """The program's recorder, or None where the program has none."""
    mod = importlib.import_module("brdf_tpu_torch.utils.profiling")
    return mod if all(hasattr(mod, f) for f in ("enable", "reset", "records", "counters")) \
        else None


def _loop_syncs():
    return getattr(importlib.import_module("brdf_tpu_torch.ops.ne"), "LOOP_SYNCS", None)


def install(tracer) -> None:
    prof = _profiling()
    if prof is not None:
        prof.reset()
        prof.enable(True)
    tracer.records[SYNCS] = [_loop_syncs()]


def spans(run, name: str) -> list:
    """The closed spans of ``name`` recorded in the traced requests."""
    prof = _profiling()
    if run.trace is None or not run.trace.calls or prof is None:
        return []
    return [s for s in prof.records() if s.name == name and s.end_ns is not None]


def ms_per_call(run, name: str):
    """Total milliseconds of the ``name`` spans per traced request."""
    found = spans(run, name)
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) * 1e-6 / run.trace.calls


def counter(run, name: str) -> int:
    prof = _profiling()
    if run.trace is None or prof is None:
        return 0
    return prof.counters().get(name, 0)


def syncs_per_call(run):
    """The eager loop's host synchronisations per traced request."""
    before = None if run.trace is None else run.trace.records.get(SYNCS, [None])[0]
    now = _loop_syncs()
    if before is None or now is None or not run.trace.calls or now == before:
        return None
    return (now - before) / run.trace.calls


def idle_share_inside(run, name: str):
    """100 · (1 − the union of the trace's kernels inside the ``name`` spans
    ÷ the spans' total duration)."""
    found = spans(run, name)
    total = sum(s.end_ns - s.start_ns for s in found) * 1e-9
    if not found or total <= 0:
        return None
    merged = []
    for _, start, seconds in sorted(run.trace.kernels, key=lambda k: k[1]):
        end = start + seconds
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    starts = [iv[0] for iv in merged]
    busy = 0.0
    for s in found:
        lo, hi = s.start_ns * 1e-9, s.end_ns * 1e-9
        k = max(bisect.bisect_right(starts, lo) - 1, 0)
        while k < len(merged) and merged[k][0] < hi:
            busy += max(0.0, min(hi, merged[k][1]) - max(lo, merged[k][0]))
            k += 1
    return 100.0 * (1.0 - busy / total)
