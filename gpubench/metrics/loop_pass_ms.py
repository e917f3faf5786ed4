"""Mean milliseconds of one pass of the eager LM loop (the program's
``lm.pass`` spans: two kernel launches, the elementwise update and the host
synchronisation that ends the pass)."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    found = spans.spans(run, "lm.pass")
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) * 1e-6 / len(found)
