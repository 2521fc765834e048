"""100 minus the union of the device's intervals (kernels, copies, memsets)
over the traced window, in %."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
