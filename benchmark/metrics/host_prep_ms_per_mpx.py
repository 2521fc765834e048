"""Self time of the program's host-prep spans (``xs.validate``,
``xs.tables``, ``xs.prep``, ``xs.merge``: each less the ``xs.*`` spans
inside it) in the traced window, in ms per million pixels inverted; None
when the program records no spans."""

from benchmark import spans

NAMES = ("xs.validate", "xs.tables", "xs.prep", "xs.merge")


def read(run):
    if run.trace is None or run.pixels <= 0:
        return None
    own = spans.self_us(run.trace)
    if not own:
        return None
    return sum(own.get(name, 0.0) for name in NAMES) / 1e3 / (run.pixels / 1e6)
