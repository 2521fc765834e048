"""Spans and counters of the port, on the profiler's clock.

* :func:`span` is a ``torch.profiler.record_function`` range while a profiler
  runs, so the trace shows it beside the kernels it enqueued, and one shared
  null context otherwise: no allocation, no clock read, one cheap check. A
  span never synchronizes the card. Its name is a fixed string (``xs.call``,
  ``xs.prep``, ...): nothing about the call goes into a name, so the trace's
  names stay the same from run to run.
* :func:`count` adds to a cumulative integer counter, always on, one dict
  behind a lock: ``pieces``, ``read_bytes`` (a piece's bytes of the
  host source arrays, memory-mapped files included, as handed to the cast;
  an array broadcast to the scene adds none), ``h2d_bytes``, ``d2h_bytes``,
  ``pinned_new_bytes``, ``builds``, the dual-pol pixels merged by the
  ``dual_merge`` kernel (``merge_px_card``) and by numpy on the host
  (``merge_px_host``), the bucket slots K1-K4 read through the bucket
  permutation (``perm_rows_read``), the launches whose range guards read
  their indices back, one host wait each (``range_checks``), the launches
  whose indices their maker, the fused closure, marked in range, launched
  with no wait (``range_checks_waived``), the bucketings' sorts launched
  through the narrow radix sort (``narrow_sorts``) and the key bits they
  sorted, summed (``sort_bits``), and the kernel launches of each
  wrapper (``launch/<wrapper>`` for the inversion's kernels,
  ``launch.experiment/<kernel>`` for the experiment kernels).
* :class:`call` is the ``xs.call`` span of one entry-point call. While
  :class:`xsarsea_tpu_torch.utils.trace` records, and only then, it also
  appends one record of the call: the entry point, its pixels and wall
  seconds, the change of every counter, the pinned pool's bytes and the
  device allocator's new segments (its ``cudaMalloc`` calls).

The spans, nested as they run (the fused stages inside ``xs.compute``):

=================  ============================================================
``xs.call``        an ``invert_pixels`` or ``invert_from_model`` call
``xs.validate``    ``_raw_data``, the pol checks, ``_any_valid``
``xs.tables``      ``prepare_tables`` and the closure lookup; ``xs.build`` on a
                   miss, and around the kernel library's load or build
``xs.prep``        one piece's inputs: host slicing and dB, the casts into
                   pinned buffers, the copies issued (on the prep worker when
                   the lanes overlap); ``xs.pin`` pins a new buffer
``xs.read``        inside ``xs.prep``: one source array's rows of the piece
                   taken (``_flat_slice``: the rows of a chunked or broadcast
                   array materialized), before any cast; a memory-mapped
                   file's view is read in the cast that follows
``xs.compute``     one piece's inversion: ``xs.bucket``, ``xs.coarse`` (K1),
                   ``xs.rebucket``, ``xs.refine`` (K2, or K3 and K4),
                   ``xs.post`` in the fused modes
``xs.wait.prep``   the caller waiting for the prep worker's next piece
``xs.wait.drain``  the caller waiting for the drain worker
``xs.drain``       a piece's winds written into the outputs; ``xs.wait.copy``
                   waits for their copy from the card
``xs.cat``         the pieces' results joined on the device
``xs.merge``       the dual-pol merge where the host does it (a CPU or float64
                   call; on the card the kernel merges inside ``xs.compute``)
                   and the wrap into DimArrays
=================  ============================================================
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["span", "count", "counters", "reset", "call", "start_recording", "stop_recording"]

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counters = dict.fromkeys(("pieces", "read_bytes", "h2d_bytes", "d2h_bytes", "pinned_new_bytes",
                           "builds", "merge_px_card", "merge_px_host", "perm_rows_read",
                           "range_checks", "range_checks_waived", "narrow_sorts",
                           "sort_bits"), 0)
# set by utils.trace: its profiler follows every thread, where the
# profiler-enabled check reads false even on the thread that started it
_all_threads = False
# the active trace's call records, or None when no trace records calls
_calls = None


def span(name):
    """A profiler range named ``name`` while a profiler runs, else a shared
    null context."""
    if _all_threads or torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name, n=1):
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters(prefix=""):
    """The counters whose name starts with ``prefix``, keyed by the rest of
    their name."""
    with _lock:
        return {k[len(prefix):]: v for k, v in _counters.items() if k.startswith(prefix)}


def reset(prefix):
    """Drop the counters whose name starts with ``prefix``."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]


def _record(device):
    """What a call record reads at the call's start and end: every counter,
    and the device allocator's segments allocated so far."""
    out = counters()
    out["alloc_segments"] = torch.cuda.memory_stats(device).get("segment.all.allocated", 0) \
        if device.type == "cuda" else 0
    return out


class call:
    """The ``xs.call`` span of an entry point's call on ``device``; set
    ``pixels`` inside. While a trace records calls, the call's record is
    appended to it on exit."""

    __slots__ = ("entry", "device", "pixels", "_span", "_calls", "_start", "_t0")

    def __init__(self, entry, device, pixels=0):
        self.entry, self.device, self.pixels = entry, torch.device(device), pixels

    def __enter__(self):
        self._span = span("xs.call")
        self._span.__enter__()
        self._calls = _calls
        if self._calls is not None:
            self._start = _record(self.device)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self._calls is not None:
                seconds = time.perf_counter() - self._t0
                from xsarsea_tpu_torch.utils.staging import pool  # staging imports this module

                end = _record(self.device)
                rec = {"entry": self.entry, "pixels": int(self.pixels), "seconds": seconds,
                       "pinned_bytes": pool().bytes}
                rec.update({k: v - self._start.get(k, 0) for k, v in end.items()})
                with _lock:
                    self._calls.append(rec)
        finally:
            self._span.__exit__(*exc)
        return False


def start_recording(all_threads):
    """Keep a record of every entry-point call from now on (``utils.trace``);
    ``all_threads``: the profiler follows every thread."""
    global _calls, _all_threads
    _calls, _all_threads = [], bool(all_threads)


def stop_recording():
    """Stop keeping records and return those kept."""
    global _calls, _all_threads
    calls, _calls, _all_threads = _calls or [], None, False
    return calls
