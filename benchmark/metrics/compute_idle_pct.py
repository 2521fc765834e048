"""Device idle time (no kernel, copy or memset) inside the program's
``xs.compute`` spans, the pieces' inversions, over the traced window, in %;
None when the program records no spans. The rest of
``device_idle_pct.resident`` lies outside the pieces: the rest of the call
and the harness between calls."""

from benchmark import spans


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    idle = spans.idle_inside_us(run.trace, "xs.compute")
    if idle is None:
        return None
    return 100.0 * idle / run.trace.window_us
