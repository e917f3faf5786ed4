"""The traced segment: a bounded number of requests at the end of the warm
window under ``torch.profiler``, and what the per-layer readers read of it.

The segment is bracketed by a small kernel on each side, so that no launch
at its edge is lost from the trace. Each request runs inside a
``gpubench.request`` span; the span of the traced requests is the window
that the device's busy time is measured against. The hand-written kernels'
launches in the trace are checked against the program's own launch counters.
A metric reader may also ask for the arguments of a program function while
the segment runs (``Tracer.record``), for counts that only the arguments
give (sizes, modes, iterations taken).
"""

from __future__ import annotations

import dataclasses
import importlib
import re
import sys
from collections import defaultdict

import torch

SPAN = "gpubench.request"
# hand-written kernels: a pattern on the trace's kernel name, and the
# program's launch counter that counts the same launches
COUNTED = (
    ("K1", r"\bvarpro_kernel\b", "brdf_tpu_torch.ops.varpro", "LAUNCHES", None),
    ("K5", r"\blm_kernel\b", "brdf_tpu_torch.ops.lm", "LAUNCHES", None),
    ("K8", r"\bvarpro_nd_kernel\b", "brdf_tpu_torch.ops.varpro_nd", "LAUNCHES", None),
    ("K6", r"\bne_kernel\b", "brdf_tpu_torch.ops.ne", "LAUNCHES", "ne"),
    ("K7", r"\bjoint_ne_kernel\b", "brdf_tpu_torch.ops.ne", "LAUNCHES", "joint_ne"),
    ("K2", r"\bshade_fwd_kernel\b", "brdf_tpu_torch.ops.shading", "SHADE_LAUNCHES", "fwd"),
    ("K3", r"\bshade_bwd_params(_ahead)?_kernel\b", "brdf_tpu_torch.ops.shading",
     "SHADE_LAUNCHES", "bwd_params"),
    ("K4", r"\bshade_bwd_angles_kernel\b", "brdf_tpu_torch.ops.shading", "SHADE_LAUNCHES",
     "bwd_angles"),
    ("K0", r"\blobes_eval_kernel\b", "brdf_tpu_torch.ops.shading", "LAUNCHES", None),
)


def _counter(module: str, attr: str, key):
    mod = sys.modules.get(module)
    if mod is None:
        return 0
    value = getattr(mod, attr, 0)
    return value.get(key, 0) if key is not None else value


def counters() -> dict:
    return {label: _counter(mod, attr, key) for label, _, mod, attr, key in COUNTED}


class Tracer:
    """Wraps program functions for the traced segment only; each call's
    ``fn(args, kwargs, result)`` is appended to ``records[key]``."""

    def __init__(self):
        self.records = defaultdict(list)
        self._saved = []

    def record(self, key: str, module: str, attr: str, fn) -> None:
        mod = importlib.import_module(module)
        original = getattr(mod, attr)

        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            self.records[key].append(fn(args, kwargs, out))
            return out

        self._saved.append((mod, attr, original))
        setattr(mod, attr, wrapper)

    def restore(self) -> None:
        while self._saved:
            mod, attr, original = self._saved.pop()
            setattr(mod, attr, original)


@dataclasses.dataclass
class Trace:
    calls: int                  # traced requests
    span_s: float               # first traced request's start to the last one's end
    busy_s: float               # union of the device's operations inside the span
    kernels: list               # (name, start_s, seconds) of every kernel in the span
    device_ops: list            # [[name, seconds]] by total device time, largest first
    idle_gaps: list             # [[host operation, seconds]] idle time by what the host did
    launch_check: dict          # label -> (kernels in the trace, counter delta)
    records: dict               # Tracer.records

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.kernels if rx.search(n))


_ANON = "(anonymous namespace)::"


def _short(name: str) -> str:
    """A kernel or operator name without its argument list and return type."""
    name = name.replace(_ANON, "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:100]


@dataclasses.dataclass
class Event:
    name: str
    device: bool       # ran on the device (kernel, copy, fill)
    start: float       # seconds, the trace's own clock
    end: float
    thread: int


def events_of(prof) -> list:
    """The trace's events, read from the profiler's raw results (building
    its per-operator tree costs minutes for a trace of 10^5 launches)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), str(e.device_type()).endswith("CUDA"), start,
                         start + e.duration_ns() * 1e-9, e.start_thread_id()))
    return out


def summarize(events: list, calls: int, launch_check: dict, records: dict) -> Trace:
    spans = [e for e in events if e.name == SPAN and not e.device]
    lo = min(e.start for e in spans)
    hi = max(e.end for e in spans)
    main = spans[0].thread
    ivs = sorted((max(e.start, lo), min(e.end, hi), e.name) for e in events
                 if e.device and not e.name.startswith("gpubench") and e.end > lo and e.start < hi)
    merged = []
    for s, t, _ in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    by_name = defaultdict(float)
    for s, t, n in ivs:
        by_name[_short(n)] += t - s
    kernels = [(n, s, t - s) for s, t, n in ivs if not n.startswith(("Memcpy", "Memset"))]
    # idle gaps inside the span, each named by the innermost host operation
    # of the requests' thread that encloses its midpoint
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = sorted(((e.start, e.end, e.name) for e in events
                   if not e.device and e.thread == main), key=lambda x: (x[0], -x[1]))
    idle = defaultdict(float)
    stack, k = [], 0
    for s, t in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + t) / 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[_short(stack[-1][2]) if stack else "(no host operation)"] += t - s
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return Trace(calls, hi - lo, busy, kernels, [list(x) for x in top],
                 [list(x) for x in gaps_top], launch_check, dict(records))


def capture(request, first: int, calls: int, device, tracer: Tracer) -> Trace:
    """Run ``calls`` requests under the profiler and summarise the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    before = counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=device).add_(1.0)
        for i in range(calls):
            with record_function(SPAN):
                request(first + i)
        torch.zeros(1, device=device).add_(1.0)
        torch.cuda.synchronize(device)
    after = counters()
    tracer.restore()
    events = events_of(prof)
    check = {}
    for label, pattern, *_ in COUNTED:
        delta = after[label] - before[label]
        rx = re.compile(pattern)
        seen = sum(1 for e in events if e.device and rx.search(e.name))
        if delta or seen:
            check[label] = (seen, delta)
    return summarize(events, calls, check, tracer.records)
