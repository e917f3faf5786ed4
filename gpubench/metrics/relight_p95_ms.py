"""95th percentile of the wall time of every relight request in the window."""

from gpubench.core import percentile


def read(run):
    if run.window is None or run.entry.units != "images":
        return None
    return percentile(run.window.times, 95) * 1e3
