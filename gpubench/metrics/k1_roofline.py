"""K1's share of its roofline: the bound of the K1 launches in the traced
requests (``counts/k1.py`` at the H100's peaks) over their device time."""

from gpubench.counts import k1, peaks

KERNEL = r"\bvarpro_kernel\b"


def _launch(args, kwargs, out):
    cfg, ang, _, _, sig0 = args[:5]
    iters = kwargs["iters"] if "iters" in kwargs else args[5]
    return dict(model=cfg.model, a=ang.shape[0], v=ang.shape[1], t=ang.shape[2],
                grid=len(cfg.grid_sig), iters=int(iters), with_p0=sig0 is not None)


def install(tracer):
    tracer.record("k1", "brdf_tpu_torch.ops.varpro", "varpro_rows_cuda", _launch)


def read(run):
    tr = run.trace
    recs = [] if tr is None else tr.records.get("k1", [])
    seconds = 0.0 if tr is None else tr.kernel_seconds(KERNEL)
    if not recs or seconds <= 0:
        return None
    bound = sum(peaks.bound_seconds(k1.nbytes(r["a"], r["t"], r["v"], r["with_p0"]),
                                    k1.operations(r["model"], r["t"], r["v"], r["grid"],
                                                  r["iters"], r["with_p0"])) for r in recs)
    return 100.0 * bound / seconds
