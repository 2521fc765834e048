"""Time the calling thread spent waiting for the drain worker (the union of
the program's ``xs.wait.drain`` spans: the kernels waiting on the lane that
copies the winds out and writes them, first touch included, into the host
outputs) in the traced window, in ms per million pixels inverted; None when
the program records no spans."""

from benchmark import spans


def read(run):
    if run.trace is None or run.pixels <= 0:
        return None
    waited = spans.union_of(run.trace, "xs.wait.drain")
    if waited is None:
        return None
    return waited / 1e3 / (run.pixels / 1e6)
