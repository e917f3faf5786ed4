"""Milliseconds of the image fill on the host (the program's
``render.scatter`` spans: the background image and the covered pixels'
scatter), per traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.ms_per_call(run, "render.scatter")
