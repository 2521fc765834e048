"""Self time of the program's scene-preparation spans (``xs.nesz``, the
NESZ's scene-wide pass and row fit; ``xs.dsig``, a piece's flattened NESZ
and ``dsig_cr``: each less the ``xs.*`` spans inside it) in the traced
window, in ms per million pixels inverted; None when the program records
neither span."""

from benchmark import spans

NAMES = ("xs.nesz", "xs.dsig")


def read(run):
    if run.trace is None or run.pixels <= 0:
        return None
    own = spans.self_us(run.trace)
    if not any(name in own for name in NAMES):
        return None
    return sum(own.get(name, 0.0) for name in NAMES) / 1e3 / (run.pixels / 1e6)
