"""K8's share of its roofline: the bound of the K8 calls in the traced
requests (``counts/k8.py`` at the H100's peaks), each call's shape read from
the program's ``varpro_nd`` span, over the K8 launches' device time."""

from gpubench import spans
from gpubench.counts import k8, peaks

KERNEL = r"\bvarpro_nd_kernel\b"


def install(tracer):
    spans.install(tracer)


def read(run):
    found = spans.spans(run, "varpro_nd")
    seconds = 0.0 if run.trace is None else run.trace.kernel_seconds(KERNEL)
    if not found or seconds <= 0:
        return None
    bound = 0.0
    for s in found:
        a = s.attrs
        bound += peaks.bound_seconds(
            k8.nbytes(a["model"], a["lanes"], a["views"], a["with_p0"]),
            k8.operations(a["model"], a["lanes"], a["views"], a["grid"], a["iters"], a["with_p0"]))
    return 100.0 * bound / seconds
