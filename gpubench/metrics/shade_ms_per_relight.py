"""Milliseconds of the shading on the device (the program's ``render.shade``
spans: the angles, the upload, K2 and the copy back), per traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.ms_per_call(run, "render.shade")
