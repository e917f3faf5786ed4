"""The device's idle share inside the eager LM loop's passes: 100 · (1 −
the union of the trace's kernels inside the ``lm.pass`` spans ÷ the spans'
total duration), in percent; the spans and the kernels share the profiler's
clock."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    return spans.idle_share_inside(run, "lm.pass")
