"""Milliseconds of the eager linear grid init (the program's ``fit.init``
spans: one a fit in ``.lm``, one a channel in the joint fit), per traced
request. K1 inits inside the kernel: ``.varpro`` records none."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.ms_per_call(run, "fit.init")
