"""Host-to-device and device-to-host bytes of the traced window over the
profiler's time of those copies, in GB/s."""


def read(run):
    if run.trace is None:
        return None
    n_bytes, us = run.trace.memcpy()
    if us <= 0 or n_bytes <= 0:
        return None
    return n_bytes / (us * 1e-6) / 1e9
