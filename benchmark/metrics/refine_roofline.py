"""The least time of the layer's work in the traced window (the roofline
of :mod:`benchmark.roofline`, from the cell's shapes), as a share of the
profiler's device time of the layer's kernels, in %."""

LAYER = "slab refine and crosspol tail (K2; or K3 + K4)"


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.layer_us(LAYER) / 1e6
    if seconds <= 0:
        return None
    return 100.0 * run.bounds[LAYER] / seconds
