"""Host staging for copies to and from a CUDA device.

A copy between pageable host memory and the device goes through small
staging buffers inside the CUDA runtime and holds the calling thread for its
whole length; a copy from or into page-locked ("pinned") memory is one DMA transfer
that returns at once and can overlap kernels on another stream. Pinning
memory costs time, so the buffers come from a pool (:class:`PinnedPool`) and
are reused across pieces and calls.

* :func:`to_device` casts a host array straight into a pinned buffer and
  starts the copy on the current stream with ``non_blocking=True``;
* :class:`HostCopy` starts a device-to-host copy into a pinned buffer, on the
  current stream or on a side stream after the work already enqueued, and
  writes it into a numpy array once its event has fired;
* :func:`to_host` is the whole trip, a few chunks in flight, into ``out`` or
  a new array;
* :func:`prefault` faults the pages of fresh host arrays in on a worker
  thread, so that a later copy into them only copies.

On ``device="cpu"`` these are plain numpy/torch conversions: that is where
the caller asked to compute, not a fallback, and no pinned memory is touched.
"""

from __future__ import annotations

import mmap
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from xsarsea_tpu_torch.utils.spans import count, span

__all__ = ["PinnedPool", "HostCopy", "pool", "prefault", "to_device", "to_host", "np_dtype",
           "torch_dtype"]

_MIN_BUFFER = 1 << 16  # bytes; smaller host arrays are not worth a staging buffer
_CHUNK_BYTES = 1 << 25  # to_host's chunk: two in flight bound its pinned memory


def torch_dtype(dtype):
    """A ``torch.dtype`` for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def np_dtype(dtype):
    """A numpy dtype for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class PinnedPool:
    """Page-locked host buffers, lent out and taken back.

    Buffers are ``uint8`` tensors of a power-of-two size. :meth:`give` with an
    event keeps the buffer aside until the event has fired (the copy that
    reads or writes it is done). ``bytes`` counts what the pool has pinned and
    not dropped, lent or free; ``peak_bytes`` its maximum. Free buffers beyond
    ``cap_bytes`` are dropped, largest first. Thread-safe.
    """

    def __init__(self, cap_bytes=1 << 30):
        self.cap_bytes = cap_bytes
        self.bytes = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()
        self._free = []
        self._pending = deque()

    @staticmethod
    def _alloc(nbytes):
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def _reclaim(self):
        """Move the buffers whose event has fired to the free list, which is
        kept in order of size."""
        while self._pending and self._pending[0][0].query():
            self._free.append(self._pending.popleft()[1])
        self._free.sort(key=torch.Tensor.numel)

    def take(self, nbytes):
        """A buffer of at least ``nbytes`` bytes."""
        size = max(_MIN_BUFFER, 1 << max(0, int(nbytes) - 1).bit_length())
        with self._lock:
            self._reclaim()
            for i, buf in enumerate(self._free):
                if buf.numel() >= nbytes:  # the first fit is the smallest
                    return self._free.pop(i)
            self.bytes += size
            self.peak_bytes = max(self.peak_bytes, self.bytes)
        count("pinned_new_bytes", size)
        with span("xs.pin"):
            return self._alloc(size)

    def give(self, buf, after=None):
        """Take ``buf`` back, for reuse once event ``after`` has fired."""
        with self._lock:
            if after is not None and not after.query():
                self._pending.append((after, buf))
            else:
                self._free.append(buf)
            self._reclaim()
            while self._free and self.bytes > self.cap_bytes:
                self.bytes -= self._free.pop().numel()

    def view(self, buf, shape, dtype):
        """The head of ``buf`` as a tensor of ``shape`` and torch ``dtype``."""
        n = int(np.prod(shape, dtype=np.int64))
        return buf[:n * dtype.itemsize].view(dtype).view(tuple(shape))


_POOL = PinnedPool()


def pool():
    """The process's pool of pinned buffers."""
    return _POOL


def to_device(a, device, dtype=None):
    """``a`` (a tensor or anything numpy reads) as a tensor on ``device`` in
    ``dtype`` (default: the dtype it has).

    A host array bound for a CUDA device is cast into a pinned buffer in one
    pass and copied from there on the current stream without blocking; the
    buffer returns to the pool when the copy is done. Work enqueued on that
    stream afterwards sees the data; another stream must wait for it.
    """
    device = torch.device(device)
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or device.type == "cpu":
            return a.to(device=device, dtype=dtype)
        a = a.detach().numpy()
    a = np.asarray(a)
    tdtype = torch_dtype(a.dtype if dtype is None else dtype)
    nbytes = a.size * tdtype.itemsize
    if device.type == "cuda":
        count("h2d_bytes", nbytes)
    if device.type == "cpu" or nbytes < _MIN_BUFFER:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np_dtype(tdtype)), device=device)
    buf = _POOL.take(nbytes)
    host = _POOL.view(buf, a.shape, tdtype)
    np.copyto(host.numpy(), a, casting="unsafe")
    with torch.cuda.device(device):
        dev = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    _POOL.give(buf, after=done)
    return dev


class HostCopy:
    """A device-to-host copy of tensor ``t`` in flight.

    On a CUDA tensor the copy into a pinned buffer starts at once: on
    ``stream`` after everything the current stream holds so far (so kernels
    enqueued later overlap it), or on the current stream when ``stream`` is
    None. :meth:`into` waits for it and writes the values into a numpy array.
    A CPU tensor is held as it is and read by :meth:`into`.
    """

    def __init__(self, t, stream=None):
        t = t.detach()
        self._buf = None
        if t.device.type == "cpu":
            self._host = t
            return
        t = t.contiguous()
        count("d2h_bytes", t.numel() * t.element_size())
        self._buf = _POOL.take(t.numel() * t.element_size())
        self._host = _POOL.view(self._buf, t.shape, t.dtype)
        with torch.cuda.device(t.device):
            current = torch.cuda.current_stream()
            if stream is None:
                stream = current
            else:
                stream.wait_stream(current)
                # the allocator may hand t's block out again as soon as the
                # current stream is done with it: not before this copy is
                t.record_stream(stream)
            with torch.cuda.stream(stream):
                self._host.copy_(t, non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record()

    def into(self, out):
        """Write the values into ``out`` (same shape) and return it."""
        if self._buf is None:
            out[...] = self._host.numpy()
            return out
        with span("xs.wait.copy"):
            self._done.synchronize()
        out[...] = self._host.numpy()
        _POOL.give(self._buf)
        self._buf = self._host = None
        return out


_faulter = None
_faulter_lock = threading.Lock()


def _touch(arrays):
    for a in arrays:
        a.reshape(-1).view(np.uint8)[::mmap.PAGESIZE] = 0  # one byte a page


def prefault(*arrays):
    """Fault the pages of fresh C-contiguous host arrays in on a worker
    thread while the caller goes on: one byte a page is written (0), the
    rest is left as it was, for the caller to overwrite. A first write into
    fresh memory takes a page fault a page, which costs more than the copy
    itself. Returns the touch's future: wait on it before writing."""
    global _faulter
    with _faulter_lock:
        if _faulter is None:
            _faulter = ThreadPoolExecutor(max_workers=1, thread_name_prefix="xs-prefault")
    return _faulter.submit(_touch, arrays)


def to_host(t, out=None):
    """Tensor ``t`` as a host numpy array, written into ``out`` when given.

    A CPU tensor gives its own memory (or is copied into ``out``). A CUDA
    tensor comes over in chunks of 32 MiB through pinned buffers, two in
    flight, so a chunk's copy overlaps the previous chunk's move into the
    result. ``out`` must be 1-D or C-contiguous.
    """
    t = t.detach()
    if t.device.type == "cpu":
        if out is None:
            return t.numpy()
        out[...] = t.numpy()
        return out
    result = np.empty(tuple(t.shape), dtype=np_dtype(t.dtype)) if out is None else out
    if tuple(result.shape) != tuple(t.shape):
        raise ValueError(f"out has shape {result.shape}, the tensor {tuple(t.shape)}")
    if result.ndim > 1 and not result.flags.c_contiguous:
        raise ValueError("out must be 1-D or C-contiguous")
    flat, dest = t.contiguous().reshape(-1), result.reshape(-1)
    step = max(1, _CHUNK_BYTES // t.element_size())
    flying = deque()
    for lo in range(0, flat.shape[0], step):
        flying.append((lo, HostCopy(flat[lo:lo + step])))
        if len(flying) == 2:
            lo0, copy = flying.popleft()
            copy.into(dest[lo0:lo0 + step])
    for lo0, copy in flying:
        copy.into(dest[lo0:lo0 + step])
    return result
