"""K5's share of its roofline: the bound of the work the K5 launches in the
traced requests needed (``counts/k5.py``: from the iterations each lane
took) over their device time."""

from gpubench.counts import k5, peaks

KERNEL = r"\blm_kernel\b"


def _launch(args, kwargs, out):
    cfg, ang = args[:2]
    # row 6 of the output holds each lane's iterations; read after the trace
    return dict(model=cfg.model, v=ang.shape[1], t=ang.shape[2], iters=out[6])


def install(tracer):
    tracer.record("k5", "brdf_tpu_torch.ops.lm", "lm_rows_cuda", _launch)


def read(run):
    tr = run.trace
    recs = [] if tr is None else tr.records.get("k5", [])
    seconds = 0.0 if tr is None else tr.kernel_seconds(KERNEL)
    if not recs or seconds <= 0:
        return None
    bound = sum(peaks.bound_seconds(
        k5.nbytes(r["model"], r["t"], r["v"]),
        k5.operations(r["model"], r["v"], r["t"], float(r["iters"].double().sum())))
        for r in recs)
    return 100.0 * bound / seconds
