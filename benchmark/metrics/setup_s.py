"""Seconds from the process's start to the first timed scene: imports, the
CUDA context, the kernel library (built once a checkout), the tables, the
scene pool and a warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
