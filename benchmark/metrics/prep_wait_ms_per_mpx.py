"""Time the calling thread spent waiting for the prep worker's next piece
(the union of the program's ``xs.wait.prep`` spans: the kernels waiting on
the lane that reads, casts and copies the pieces in) in the traced window,
in ms per million pixels inverted; None when the program records no
spans."""

from benchmark import spans


def read(run):
    if run.trace is None or run.pixels <= 0:
        return None
    waited = spans.union_of(run.trace, "xs.wait.prep")
    if waited is None:
        return None
    return waited / 1e3 / (run.pixels / 1e6)
