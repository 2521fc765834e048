"""Device time of every kernel outside the port's own CUDA kernels (torch's
sorts, gathers, scatters and elementwise work) in the traced window, in ms
per million pixels inverted."""

LAYER = "bucketing, feature gathers, scatter back"


def read(run):
    if run.trace is None or run.pixels <= 0:
        return None
    return run.trace.layer_us(LAYER) / 1e3 / (run.pixels / 1e6)
