"""How often the m = 11 joint fit's solve runs as one launch of its
hand-written kernel, per traced request: the program's counter
``levmar.kernel_solves``, one a launch of ``csrc/joint_levmar.cu``. A
program that has the kernel but launched it in no traced request reads 0;
one without it (no ``brdf_tpu_torch.ops.joint_levmar``) reads nothing."""

import importlib.util

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    prof = spans._profiling()
    if run.trace is None or not run.trace.calls or prof is None:
        return None
    if importlib.util.find_spec("brdf_tpu_torch.ops.joint_levmar") is None:
        return None
    return prof.counters().get("levmar.kernel_solves", 0) / run.trace.calls
