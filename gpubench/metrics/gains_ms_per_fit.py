"""Milliseconds of the gain rounds of a joint fit with per-view rig gains
(the program's ``fit.gains`` spans: the prediction, its copy to the host and
the closed-form gain solve), per traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.ms_per_call(run, "fit.gains")
