"""The useful share of the eager LM solver's lane-iterations: 100 · the
iterations its lanes ran (counter ``levmar.active_lanes``) ÷ the lanes
times the outer iterations the solves ran (counter ``levmar.lanes``), in
percent. Every outer iteration evaluates every lane, stopped ones too."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    lanes = spans.counter(run, "levmar.lanes")
    if not lanes:
        return None
    return 100.0 * spans.counter(run, "levmar.active_lanes") / lanes
