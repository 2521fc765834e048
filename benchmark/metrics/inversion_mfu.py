"""The least time of the whole inversion's work in the traced window (the
coarse pass's and the refine's rooflines summed) as a share of the window's
wall time, in %: the share of the card's peak the whole call reaches, which
still bounds a gain when a later change fuses or removes a kernel."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * sum(run.bounds.values()) / (run.trace.window_us / 1e6)
