# Adapted from brdf_tpu/utils/profiling.py (the port imports nothing of brdf_tpu).
"""Timing and throughput instrumentation.

Replaces the reference's fps ring buffer (``glutcallbacks.cpp:607-619``) and
levmar's nfev/njev counters with: wall timers that wait for the device,
rays/s-style throughput math, and a ``torch.profiler`` trace helper.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class Timer:
    """Wall-clock timer whose region ends when the device has finished.

    CUDA work is asynchronous: where CUDA is in use the timer synchronises
    every CUDA device at entry and at exit, so ``seconds`` covers the work
    enqueued inside the region and not only its launch."""

    def __init__(self):
        self.seconds = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.seconds = time.perf_counter() - self._t0
        return False


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def rays_per_sec(texels: int, views: int, seconds: float, passes: int = 1) -> float:
    """Shading throughput: one 'ray' = one (texel, view) shading evaluation;
    ``passes`` = 2 counts forward+backward (the BASELINE Mrays/s metric)."""
    return texels * views * passes / seconds


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """A ``torch.profiler`` trace of the region (host and, where a CUDA
    device is present, device activity) written as a Chrome trace into
    ``logdir``; a no-op without a ``logdir``."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
