"""The device's idle share of the traced requests' span: 1 − (union of the
device's operations inside the span ÷ the span), in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
