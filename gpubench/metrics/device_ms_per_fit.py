"""Milliseconds in which an operation ran on the device, per traced request."""


def read(run):
    tr = run.trace
    if tr is None or not tr.calls or tr.busy_s <= 0:
        return None
    return tr.busy_s * 1e3 / tr.calls
