"""Batch multi-scene inversion (counterpart of ``xsarsea_tpu.parallel.batch``).

Archive reprocessing inverts many scenes of different shapes. The inversion
is independent per pixel, so the scenes are one concatenated flat stream of
pixels, cut into pieces that flow through the device: host memory stays
O(piece) + O(outputs), and a lazy scene (a memmap, or any duck array with
first-axis slicing) is read a few rows at a time, never whole. Without a
mesh, or with a mesh of one device, the stream goes through the one-device
overlapped piece loop (``windspeed.inversion._invert_source``); over a
larger mesh, piece by piece through :func:`sharded_invert_pixels`.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.parallel.inversion import sharded_invert_pixels
from xsarsea_tpu_torch.utils import staging
from xsarsea_tpu_torch.windspeed.inversion import _flat_slice, _invert_source, _real_imag

__all__ = ["invert_scenes"]


class _SceneSource:
    """Piece source over one scene dict of already-dB streams (``inc``,
    ``sigma0_co_db``, ``sigma0_cr_db``, ``dsig_cr``, ``ancillary_wind``):
    each piece slices O(piece) host elements (:func:`_flat_slice`).
    ``dsig_cr`` may be a scalar or broadcastable to the scene."""

    def __init__(self, scene):
        self.shape = tuple(int(s) for s in np.shape(scene["inc"]))
        self.n = int(np.prod(self.shape, dtype=np.int64))
        self._streams = (scene["inc"], scene["sigma0_co_db"], scene["sigma0_cr_db"])
        self._dsig = scene["dsig_cr"]
        self._anc = scene["ancillary_wind"]

    def streams(self, lo, hi, device, dtype):
        def put(a):
            return staging.to_device(_flat_slice(a, self.shape, lo, hi), device, dtype)

        dsig = self._dsig
        if np.ndim(dsig) == 0:
            dsig = torch.full((hi - lo,), float(np.asarray(dsig)), dtype=dtype, device=device)
        else:
            if tuple(np.shape(dsig)) != self.shape:
                dsig = np.broadcast_to(np.asarray(dsig), self.shape)
            dsig = put(dsig)
        anc = _real_imag(_flat_slice(self._anc, self.shape, lo, hi))
        return [*(put(a) for a in self._streams), dsig,
                *(staging.to_device(part, device, dtype) for part in anc)]


class _ConcatSource:
    """Scenes' piece sources as one flat stream: a piece that spans a scene
    boundary joins the members' pieces stream by stream."""

    def __init__(self, sources):
        self.sources = sources
        self._bounds = np.concatenate([[0], np.cumsum([s.n for s in sources])]).astype(np.int64)
        self.n = int(self._bounds[-1])

    def streams(self, lo, hi, device, dtype):
        i = int(np.searchsorted(self._bounds, lo, side="right")) - 1
        parts = []
        while lo < hi:
            s, base = self.sources[i], int(self._bounds[i])
            sub_hi = min(hi, base + s.n)
            parts.append(s.streams(lo - base, sub_hi - base, device, dtype))
            lo = sub_hi
            i += 1
        if len(parts) == 1:
            return parts[0]
        return [torch.cat(cols) for cols in zip(*parts)]


def invert_scenes(tables, scenes, mesh=None, dsig_co=0.1, chunk_size=256, mode="auto",
                  piece_size=None, device="cuda"):
    """Invert a batch of dual-pol scenes, streamed piece by piece.

    ``scenes``: dicts with the 2-D streams ``inc``, ``sigma0_co_db``,
    ``sigma0_cr_db``, ``dsig_cr`` (or a scalar) and the complex
    ``ancillary_wind``; shapes may differ between scenes, and a stream may be
    any duck array with first-axis slicing. ``mesh``: a
    :class:`~xsarsea_tpu_torch.parallel.mesh.Mesh`, or None for the
    one-device path on ``device``. ``mode`` as ``invert_pixels``; under a
    mesh the fused modes need ``model == 1``. ``piece_size``: pixels a piece
    (default 2**22; under a mesh rounded up to whole lanes of ``data x
    chunk_size``).

    Returns a list of ``(wind_co, wind_dual)`` complex host arrays, one pair
    a scene, in each scene's shape.
    """
    sources = [_SceneSource(s) for s in scenes]
    src = _ConcatSource(sources)
    n = src.n
    if mesh is None or mesh.size == 1:
        co, dual = _invert_source(tables, src, dsig_co=dsig_co, chunk_size=chunk_size,
                                  mode=mode, device=device if mesh is None else
                                  mesh.devices[0][0], piece_size=piece_size)
    else:
        lane = mesh.shape["data"] * chunk_size
        piece = max(lane, -(-(piece_size or (1 << 22)) // lane) * lane)
        ctype = np.complex128 if tables.dtype == torch.float64 else np.complex64
        co = np.empty(n, dtype=ctype)
        dual = np.empty(n, dtype=ctype)
        cpu = torch.device("cpu")
        for lo in range(0, n, piece):
            hi = min(lo + piece, n)
            streams = [t.numpy() for t in src.streams(lo, hi, cpu, tables.dtype)]
            if hi - lo < piece and n > piece:
                # the tail piece padded to the others' length, as the reference does
                streams = [np.pad(a, (0, piece - (hi - lo)), constant_values=np.nan)
                           for a in streams]
            pco, pdual = sharded_invert_pixels(
                tables, *streams[:4], streams[4] + 1j * streams[5].astype(np.float64),
                mesh=mesh, dsig_co=dsig_co, chunk_size=chunk_size, mode=mode)
            co[lo:hi] = pco[:hi - lo]
            dual[lo:hi] = pdual[:hi - lo]

    out, off = [], 0
    for s in sources:
        out.append((co[off:off + s.n].reshape(s.shape), dual[off:off + s.n].reshape(s.shape)))
        off += s.n
    return out
