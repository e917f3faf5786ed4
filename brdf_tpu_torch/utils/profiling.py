"""Spans and counters of the port's own stages, and the operator's trace.

A span names a stage of the program (``fit.upload``, ``lm.pass``,
``render.gather``, …) and a counter adds up a quantity the stages see
(``lm.active_lanes``). Recording is off by default: a span site then costs
one shared null context (no clock read, no ``record_function``, nothing
kept, no device synchronisation) and :func:`count` returns at once. Turned
on (:func:`enable`), each span keeps its name, attributes, parent, request
(a root span opens a new one, its children inherit it) and its start and
end in nanoseconds of the Unix epoch, the clock of ``torch.profiler``'s
events, and opens a profiler range of its name: under a profiler the span
lands on the host thread beside the operators and the device's kernels. The
range is an operator's (PyTorch's ``_RecordFunctionFast``), not a user
annotation (``torch.profiler.record_function``): the profiler mirrors each
user annotation on the device's timeline as an event over the kernels
launched inside it, which a reader of the trace would count as device work.
Spans are host wall time: a span around asynchronous device work ends when
the work is issued, unless the stage waits for it.

Spans are kept in a bounded list (:data:`MAX_SPANS`; later spans are
counted in :func:`dropped` and not kept) until :func:`reset`. The spans of
one thread nest; the recorder is meant for the thread that runs the fit or
the render.

:func:`profiler_trace` is the operator's view of a region (``python -m
brdf_tpu_torch fit … --profile DIR``): a Chrome trace of the host and the
device with the spans in it, and ``spans.json`` with :func:`summary` and
the counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import defaultdict

import torch

MAX_SPANS = 1 << 17


@dataclasses.dataclass
class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    id: int
    name: str
    attrs: dict
    parent: int | None        # the enclosing span's id
    request: int              # the root span's request id
    start_ns: int
    end_ns: int | None = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Null:
    """The span of a site while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()
_on = False
_spans: list[Span] = []
_counters: dict[str, int] = defaultdict(int)
_state = {"ids": 0, "requests": 0, "dropped": 0}
_local = threading.local()


class _Open:
    """A span being recorded."""

    __slots__ = ("span", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.span = Span(-1, name, attrs, None, -1, 0)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        sp = self.span
        sp.id = _state["ids"]
        _state["ids"] += 1
        if stack:
            sp.parent, sp.request = stack[-1].id, stack[-1].request
        else:
            sp.request = _state["requests"]
            _state["requests"] += 1
        if len(_spans) < MAX_SPANS:
            _spans.append(sp)
        else:
            _state["dropped"] += 1
        stack.append(sp)
        self._rf = torch._C._profiler._RecordFunctionFast(sp.name)
        self._rf.__enter__()
        sp.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.span.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one stage; its ``set(**attrs)`` adds
    attributes from inside. While recording is off, one shared null context."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing while recording is off)."""
    if _on:
        _counters[name] += n


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _spans.clear()
    _counters.clear()
    _state["dropped"] = 0


def records() -> list[Span]:
    """The spans kept since the last reset, in the order they opened."""
    return list(_spans)


def counters() -> dict[str, int]:
    return dict(_counters)


def dropped() -> int:
    """Spans not kept since the last reset (the list was full)."""
    return _state["dropped"]


def summary() -> dict[str, dict]:
    """For each span name: ``count``, ``total_ms`` and ``self_ms`` (its
    spans' time less the part their child spans cover), of the closed spans."""
    done = [s for s in _spans if s.end_ns is not None]
    in_children = defaultdict(float)
    for s in done:
        if s.parent is not None:
            in_children[s.parent] += s.ms
    out = {}
    for s in done:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += s.ms
        row["self_ms"] += s.ms - in_children[s.id]
    return out


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Record the region's spans and a ``torch.profiler`` trace of it (host
    and, where a CUDA device is present, device activity). Writes into
    ``logdir`` the Chrome trace ``trace.json``, which holds the spans beside
    the operators and kernels, and ``spans.json``: :func:`summary` under
    ``spans``, the counters under ``counters``. A no-op without a ``logdir``."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = enabled()
    reset()
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as fh:
        json.dump({"spans": summary(), "counters": counters(), "dropped": dropped()}, fh,
                  indent=1)
