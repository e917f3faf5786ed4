"""Host tests of the eager LM solver's lanes (the program's counter
``levmar.syncs``: every outer and inner ``.any()`` of ``levmar_bc``), per
traced request."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    syncs = spans.counter(run, "levmar.syncs")
    if not syncs:
        return None
    return syncs / run.trace.calls
