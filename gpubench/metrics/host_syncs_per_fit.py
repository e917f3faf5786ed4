"""Host synchronisations of the eager LM loop (``ops/ne.py::LOOP_SYNCS``, one
a pass and one at each solve's end), per traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.syncs_per_call(run)
