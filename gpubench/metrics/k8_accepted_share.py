"""The useful share of K8's fixed schedule: 100 · the accepted Newton steps
summed over the lanes (counter ``varpro_nd.accepted``) ÷ the steps the
schedule ran, lanes × iterations (counter ``varpro_nd.steps``), in percent."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    steps = spans.counter(run, "varpro_nd.steps")
    if not steps:
        return None
    return 100.0 * spans.counter(run, "varpro_nd.accepted") / steps
