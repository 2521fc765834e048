"""Small shared helpers (counterpart of ``xsarsea_tpu.utils``).

Ported: the dB conversions, the ``timing`` decorator with its host and
device memory readings, and the device rule of the entry points
(:func:`resolve_device`, :func:`compute_device`) and the host staging of
copies to and from a card (:mod:`xsarsea_tpu_torch.utils.staging`). The config
loader, the test-data fetcher and the profiler context are not ported yet.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import numpy as np
import torch

from xsarsea_tpu_torch.utils.staging import to_device, to_host

logger = logging.getLogger("xsarsea_tpu_torch")
logger.addHandler(logging.NullHandler())

__all__ = ["to_dB", "from_dB", "timing", "logger", "device_memory_stats", "resolve_device",
           "compute_device", "as_tensor", "to_device", "to_host"]


def to_dB(x, eps=1e-15):
    """linear -> dB with the reference's epsilon clip (windspeed.py:126, models.py:215)."""
    if isinstance(x, torch.Tensor):
        return 10.0 * torch.log10(x + eps)
    return 10.0 * np.log10(np.asarray(x) + eps)


def from_dB(x):
    """dB -> linear (``**`` dispatches on the input's array type)."""
    return 10.0 ** (x / 10.0)


def resolve_device(device):
    """``torch.device(device)``; raises when it names CUDA and the host has
    no CUDA device, so nothing carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device '{device}' was asked for but no CUDA device is available; "
                           "pass device='cpu' to compute on the host")
    return device


def compute_device(device, *arrays):
    """Where an entry point computes: on the device of the first tensor among
    ``arrays`` (data that already lives on a device is computed there), else
    on ``device``."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def as_tensor(x, device):
    """``x`` (a tensor or anything numpy reads) as a tensor on ``device``, in
    the dtype it has (a host array goes to a card through pinned staging)."""
    return to_device(x, device)


def _rss_mb():
    """Current resident set size in MB (no psutil needed).

    Linux: /proc/self/statm (current RSS). Elsewhere: ru_maxrss, the
    lifetime peak, so deltas clip at 0 once the high-water mark is set,
    scaled per platform (macOS reports bytes, not KB).
    """
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):  # pragma: no cover - non-linux
        pass
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss / 1e6 if sys.platform == "darwin" else rss / 1e3
    except (ImportError, OSError):  # pragma: no cover - non-posix
        return float("nan")


def _cuda_in_use():
    """True once this process has a CUDA context (asking earlier would
    create one)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_stats():
    """``torch.cuda.memory_stats`` per CUDA device, keyed ``"cuda:<i>"``, with
    ``bytes_in_use`` (``torch.cuda.memory_allocated``) added; ``{}`` on a
    host without a card or before the process first used it."""
    if not _cuda_in_use():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = dict(torch.cuda.memory_stats(i))
        stats["bytes_in_use"] = torch.cuda.memory_allocated(i)
        out[f"cuda:{i}"] = stats
    return out


def timing(logger=logger.debug):
    """Decorator logging wall time, RSS delta and device memory per call.

    Counterpart of the reference ``@timing`` profiler (utils.py:100-123).
    The device is synchronized before the clock is read, so the time covers
    the work the call enqueued, and the change in allocated device memory is
    reported when the process uses a card.
    """

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            def dev_mb():
                return sum(s["bytes_in_use"] for s in device_memory_stats().values()) / 1e6

            mem0, dev0 = _rss_mb(), dev_mb()
            start = time.perf_counter()
            result = f(*args, **kwargs)
            if _cuda_in_use():
                torch.cuda.synchronize()
            logger(
                f"timing {f.__name__} : {time.perf_counter() - start:.3f}s. "
                f"mem: +{max(0.0, _rss_mb() - mem0):.1f}Mb "
                f"(device: {dev_mb() - dev0:+.1f}Mb)")
            return result

        return wrapper

    return decorator
