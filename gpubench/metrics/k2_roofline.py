"""K2's share of its roofline: the bound of the K2 launches in the traced
requests (``counts/k2.py``) over their device time."""

from gpubench.counts import k2, peaks

KERNEL = r"\bshade_fwd_kernel\b"


def _launch(args, kwargs, out):
    model, ang = args[:2]
    return dict(model=model, v=ang.shape[1], t=ang.shape[2])


def install(tracer):
    tracer.record("k2", "brdf_tpu_torch.ops.shading", "shade_fwd_cuda", _launch)


def read(run):
    tr = run.trace
    recs = [] if tr is None else tr.records.get("k2", [])
    seconds = 0.0 if tr is None else tr.kernel_seconds(KERNEL)
    if not recs or seconds <= 0:
        return None
    bound = sum(peaks.bound_seconds(k2.nbytes(r["model"], r["t"], r["v"]),
                                    k2.operations(r["model"], r["t"], r["v"])) for r in recs)
    return 100.0 * bound / seconds
