"""Milliseconds of the host gather of the covered pixels' shading inputs
(the program's ``render.gather`` spans), per traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.ms_per_call(run, "render.gather")
