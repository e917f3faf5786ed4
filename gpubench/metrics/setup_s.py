"""From the process's start to the first timed request: imports, loading
(or, in a checkout's first run, building) the kernels, making the scans and
the program's problems, and the warm-up."""


def read(run):
    return run.setup_s
