"""Milliseconds of the fit entry's host-to-device copies of the problem (the
program's ``fit.upload`` spans: angles, geometry, intensities and weights with
the channel fold), per traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.ms_per_call(run, "fit.upload")
