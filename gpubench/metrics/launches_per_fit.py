"""Kernel launches on the device in the traced requests, per request."""


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    return len(tr.kernels) / tr.calls
