"""Small shared helpers (counterpart of ``xsarsea_tpu.utils``).

The dB conversions; the two-layer YAML config (:func:`load_config`: the
packaged ``config.yml`` overridden by ``~/.xsarsea_tpu_torch/config.yml``);
the IFREMER test-data fetcher (:func:`get_test_file`); the ``timing``
decorator with its host and device memory readings; the profiler context
(:class:`trace`, ``torch.profiler`` with the card's kernels); the device rule
of the entry points (:func:`resolve_device`, :func:`compute_device`) and the
host staging of copies to and from a card
(:mod:`xsarsea_tpu_torch.utils.staging`). Not ported: the JAX package's
``enable_compilation_cache``, which configures XLA.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import socket
import time
import warnings
import zipfile

import numpy as np
import torch

from xsarsea_tpu_torch.utils import spans
from xsarsea_tpu_torch.utils.staging import to_device, to_host

logger = logging.getLogger("xsarsea_tpu_torch")
logger.addHandler(logging.NullHandler())

__all__ = ["to_dB", "from_dB", "timing", "logger", "device_memory_stats", "resolve_device",
           "compute_device", "as_tensor", "to_device", "to_host", "load_config", "get_test_file",
           "trace"]

_DEFAULT_CONFIG = {"data_dir": "/tmp"}
_DEFAULT_TEST_DATA_URL = "https://cyclobs.ifremer.fr/static/sarwing_datarmor/xsardata"


def to_dB(x, eps=1e-15):
    """linear -> dB with the reference's epsilon clip (windspeed.py:126, models.py:215)."""
    if isinstance(x, torch.Tensor):
        return 10.0 * torch.log10(x + eps)
    return 10.0 * np.log10(np.asarray(x) + eps)


def from_dB(x):
    """dB -> linear (``**`` dispatches on the input's array type)."""
    return 10.0 ** (x / 10.0)


def load_config():
    """Load config: ``~/.xsarsea_tpu_torch/config.yml`` overriding the
    packaged defaults (reference ``xsarsea.utils._load_config``,
    utils.py:27-43). Keys: ``data_dir``, ``test_data_url``. Needs pyyaml,
    which nothing on the inversion's path imports."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("load_config reads YAML and needs pyyaml: pip install pyyaml") from e

    config = dict(_DEFAULT_CONFIG)
    pkg_config = os.path.join(os.path.dirname(os.path.dirname(__file__)), "config.yml")
    for path in (pkg_config, os.path.expanduser("~/.xsarsea_tpu_torch/config.yml")):
        if os.path.exists(path):
            with open(path) as f:
                config.update(yaml.safe_load(f) or {})
    return config


def _fetch_fsspec(fsspec, url, local, res_path, iszip):
    """Download through ``fsspec.open("filecache::<url>")``: the archive stays
    in ``<data_dir>/fsspec_cache``, so a re-extraction never downloads again
    (reference utils.py:83-95)."""
    with fsspec.open(f"filecache::{url}",
                     filecache={"cache_storage": os.path.join(res_path, "fsspec_cache")}) as f:
        if iszip:
            with zipfile.ZipFile(f, "r") as zf:
                zf.extractall(res_path)
            return
        # to a temporary name, renamed on success: an interrupted download
        # must not leave a truncated file that the exists() check then serves
        part = local + ".part"
        try:
            with open(part, "wb") as out:
                while chunk := f.read(1 << 22):
                    out.write(chunk)
            os.replace(part, local)
        finally:
            if os.path.exists(part):
                os.unlink(part)


def _fetch_urllib(url, local, res_path, iszip):
    """Download with ``urllib`` (any URL it opens, ``file://`` included)."""
    import urllib.request

    tmp = local + (".zip" if iszip else ".part")
    try:
        urllib.request.urlretrieve(url, tmp)
        if iszip:
            with zipfile.ZipFile(tmp, "r") as zf:
                zf.extractall(res_path)
            os.unlink(tmp)
        else:
            os.replace(tmp, local)
    finally:
        if not iszip and os.path.exists(tmp):
            os.unlink(tmp)


def get_test_file(fname, iszip=True):
    """Path of test file ``fname`` under ``config['data_dir']``, fetched from
    the IFREMER xsardata server (or ``config['test_data_url']``) and unzipped
    when it is not there yet.

    API-compatible with ``xsarsea.utils.get_test_file`` (reference
    utils.py:46-97): a file already present is returned as is; otherwise the
    download goes through ``fsspec``'s ``filecache::`` when fsspec is
    importable (any protocol it knows: https, s3, gs, file), else through
    ``urllib``. Raises ``RuntimeError`` when the file is absent and cannot be
    fetched.
    """
    config = load_config()
    res_path = config["data_dir"]
    local = os.path.join(res_path, fname)
    if os.path.exists(local):
        return local

    url = f"{config.get('test_data_url', _DEFAULT_TEST_DATA_URL)}/{fname}" + (
        ".zip" if iszip else "")
    try:
        import fsspec
    except ImportError:
        fsspec = None
    warnings.warn(f"Downloading {url}")
    try:
        if fsspec is not None:
            _fetch_fsspec(fsspec, url, local, res_path, iszip)
        else:
            _fetch_urllib(url, local, res_path, iszip)
    except Exception as e:  # noqa: BLE001 - any transport's failure means the same to the caller
        raise RuntimeError(
            f"test file '{fname}' not found locally at {local} and download failed ({e}). "
            "Place the file manually or configure data_dir.") from e
    return local


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


def _log_enabled(log):
    """False when ``log`` is a ``logging.Logger`` method (``logger.info``...)
    whose level the logger would drop; True for any other callable."""
    owner = getattr(log, "__self__", None)
    if isinstance(owner, logging.Logger):
        level = logging.getLevelName(getattr(log, "__name__", "").upper())
        if isinstance(level, int):
            return owner.isEnabledFor(level)
    return True


def timing(logger=logger.debug):
    """Decorator logging wall time, RSS delta and device memory per call.

    Counterpart of the reference ``@timing`` profiler (utils.py:100-123).
    The device is synchronized before the clock is read, so the time covers
    the work the call enqueued, and the change in allocated device memory is
    reported when the process uses a card. When ``logger`` is a logger's
    method at a level that logger drops, the call runs bare: no clock, no
    synchronization, no memory reading.
    """

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not _log_enabled(logger):
                return f(*args, **kwargs)

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


def _all_threads_config():
    """The profiler's setting that follows every thread (the piece loop's
    workers too), where the installed torch has it; else None."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class trace:
    """Context manager around ``torch.profiler.profile``: CPU activity on
    every thread where the installed torch can follow them all, and CUDA
    activity when a card is present. On exit the trace is written into
    ``logdir`` as ``<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format,
    read by TensorBoard's profiler plugin and by Perfetto); ``path`` names
    it and ``profile`` is the finished profiler (``key_averages()``).

    The port's spans (:mod:`xsarsea_tpu_torch.utils.spans`: ``xs.call``,
    ``xs.prep``, ...) appear in it beside the kernels. ``calls`` holds one
    record per ``invert_pixels`` / ``invert_from_model`` call made inside
    (entry point, pixels, seconds, the change of each counter, pinned
    bytes, the device allocator's new segments); the trace file holds them
    too, under ``xs_calls``.

    >>> with trace("traces") as tr:
    ...     invert_pixels(tables, ...)

    Counterpart of the JAX package's ``trace`` (``jax.profiler``), with one
    difference: a profiler that cannot start raises instead of logging and
    carrying on, so a trace asked for is a trace written.
    """

    def __init__(self, logdir):
        self.logdir = str(logdir)
        self.path = None
        self.profile = None
        self.calls = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.logdir, exist_ok=True)
        config = _all_threads_config()
        self.profile = profile(activities=activities, **(
            {} if config is None else {"experimental_config": config}))
        self.profile.__enter__()
        spans.start_recording(all_threads=config is not None)
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.calls = spans.stop_recording()
        self.profile.add_metadata_json("xs_calls", json.dumps(self.calls))
        self.profile.__exit__(*exc)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        self.path = os.path.join(self.logdir, name)
        self.profile.export_chrome_trace(self.path)
        return False
