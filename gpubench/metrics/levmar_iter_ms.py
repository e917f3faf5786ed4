"""Mean milliseconds of one outer iteration of the eager box-constrained LM
solver (the program's ``levmar.iter`` spans, ``solver/lm.py::levmar_bc``:
the Jacobian, the damped solves of the inner loop and the host tests that
end them)."""

from gpubench import spans


def install(tracer):
    spans.install(tracer)


def read(run):
    found = spans.spans(run, "levmar.iter")
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) * 1e-6 / len(found)
