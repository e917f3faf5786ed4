"""The useful share of the eager LM loop's lane-passes: 100 · the active
lanes summed over the passes (counter ``lm.active_lanes``) ÷ the lanes the
passes ran (counter ``lm.lanes``), in percent."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    lanes = spans.counter(run, "lm.lanes")
    if not lanes:
        return None
    return 100.0 * spans.counter(run, "lm.active_lanes") / lanes
