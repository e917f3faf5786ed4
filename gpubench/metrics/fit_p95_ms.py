"""95th percentile of the wall time of every fit call in the window."""

from gpubench.core import percentile


def read(run):
    if run.window is None or run.entry.units != "texels":
        return None
    return percentile(run.window.times, 95) * 1e3
