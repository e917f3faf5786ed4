"""Texels whose every channel (and in a joint fit, normal) was fitted, over
all calls completed in the window, per second of the window."""


def read(run):
    if run.window is None or run.entry.units != "texels":
        return None
    return run.window.units / run.window.seconds
