"""Time the calling thread spent blocked on the card or on a lane of the
piece loop (the union of the program's ``xs.wait.*`` spans) in the traced
window, in ms per million pixels inverted; None when the program records no
spans."""

from benchmark import spans


def read(run):
    if run.trace is None or run.pixels <= 0:
        return None
    waited = spans.union_of(run.trace, "xs.wait.")
    if waited is None:
        return None
    return waited / 1e3 / (run.pixels / 1e6)
