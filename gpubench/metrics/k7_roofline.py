"""K7's share of its roofline: the bound of each K7 launch in the traced
requests, by its mode and size (``counts/k7.py``), over their device time."""

from gpubench.counts import k7, peaks

KERNEL = r"\bjoint_ne_kernel\b"


def _launch(args, kwargs, out):
    base, mode, lv = args[:3]
    return dict(base=base, mode=mode, v=lv.shape[1], t=lv.shape[2])


def install(tracer):
    tracer.record("k7", "brdf_tpu_torch.ops.ne", "joint_ne_rows_cuda", _launch)


def read(run):
    tr = run.trace
    recs = [] if tr is None else tr.records.get("k7", [])
    seconds = 0.0 if tr is None else tr.kernel_seconds(KERNEL)
    if not recs or seconds <= 0:
        return None
    bound = sum(peaks.bound_seconds(k7.nbytes(r["t"], r["v"], r["mode"]),
                                    k7.operations(r["base"], r["t"], r["v"], r["mode"]))
                for r in recs)
    return 100.0 * bound / seconds
