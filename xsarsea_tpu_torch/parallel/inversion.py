"""Sharded wind inversion over a (data, model) mesh (counterpart of
``xsarsea_tpu.parallel.inversion``).

* **data**: pixels split into equal shards, one a data row of the mesh.
* **model** (``mode="exact"``): the phi axis of the copol cost grid splits
  into equal slabs; each model shard finds, for every pixel of its data
  shard, the minimum over its slab and that minimum's flat index in the
  whole (padded) grid, in the one-device path's op order. The data shard's
  first device combines them: the least minimum, then the lowest flat index
  among equal minima, which is ``np.argmin``'s first minimum, so the result
  equals the one-device exact path's bit for bit (a NaN minimum aside: it
  leaves the reference's ``2**30`` sentinel, decoded as the reference's
  clipping gather does).
* The fused modes shard pixels only: each data shard runs the one-device
  fused pipeline, its kernels included, on its device.

The mesh's shards run as :func:`~xsarsea_tpu_torch.parallel.mesh.run_on_devices`
puts them: one program, one host thread per distinct device.
"""

from __future__ import annotations

import copy
from functools import partial

import numpy as np
import torch

from xsarsea_tpu_torch.parallel.mesh import run_on_devices
from xsarsea_tpu_torch.utils import staging
from xsarsea_tpu_torch.windspeed.inversion import (
    _FUSED_MODES,
    D_ANTENNA,
    D_AZI,
    InversionTables,
    _disambiguate_phi,
    _first_argmin,
    _nearest_index,
    _postprocess_pixel,
    invert_pixels,
)

__all__ = ["pad_tables_for_model_axis", "sharded_invert_pixels"]

_NAN_FLAT = 2 ** 30  # the combine's index where no candidate equals the minimum


def pad_tables_for_model_axis(tables: InversionTables, n_model):
    """``(tables, n_phi)``: the tables with the copol phi axis padded to a
    multiple of ``n_model`` (LUT entries 1e19, whose cost never wins; u, v,
    phi 0), and the true phi count (0 without a copol LUT)."""
    if not tables.has_co:
        return tables, 0
    n_phi = tables.co_phi.shape[0]
    pad = (-n_phi) % n_model
    if pad == 0:
        return tables, n_phi
    out = copy.copy(tables)
    out._device_copies, out._invert_fn_cache = {}, {}
    out.co_lut = np.pad(tables.co_lut, ((0, 0), (0, 0), (0, pad)), constant_values=1e19)
    out.co_u = np.pad(tables.co_u, ((0, 0), (0, pad)))
    out.co_v = np.pad(tables.co_v, ((0, 0), (0, pad)))
    out.co_phi = np.pad(tables.co_phi, (0, pad))
    out.co_phir = np.pad(tables.co_phir, (0, pad))
    return out, n_phi


def _resolve_sharded_mode(mode, tables, mesh):
    if mode == "auto":  # as invert_pixels resolves it, on a data-only mesh
        cuda = mesh.devices[0][0].type == "cuda"
        return "fused" if cuda and tables.has_co and mesh.shape["model"] == 1 else "exact"
    if mode in _FUSED_MODES:
        if mesh.shape["model"] != 1:
            raise ValueError(f"mode='{mode}' shards data only; use a mesh with model=1")
        return mode
    if mode != "exact":  # a typo must not fall through to the exact path
        raise ValueError(f"unknown inversion mode '{mode}'")
    return mode


def _padded_host(arrays, n_pad, np_dtype):
    """The pixel streams as host arrays of the tables' dtype, NaN-padded to
    ``n_pad`` (through float64, as the reference converts them)."""
    return [np.pad(np.asarray(a, np.float64), (0, n_pad - np.shape(a)[0]),
                   constant_values=np.nan).astype(np_dtype) for a in arrays]


def _to_host_complex(re, im):
    return staging.to_host(torch.complex(re, im))


def _sharded_fused(tables, arrs, n, mesh, dsig_co, chunk_size, mode):
    n_data = mesh.shape["data"]
    shard = arrs[0].shape[0] // n_data

    def one(i):
        lo, hi = i * shard, (i + 1) * shard
        s = [a[lo:hi] for a in arrs]
        return invert_pixels(tables, *s[:4], s[4] + 1j * s[5], dsig_co=dsig_co,
                             chunk_size=chunk_size, mode=mode, device=mesh.devices[i][0])

    outs = run_on_devices([(mesh.devices[i][0], partial(one, i)) for i in range(n_data)])
    return tuple(np.concatenate(parts)[:n] for parts in zip(*outs))


class _ShardedExact:
    """The exact path over a mesh, for one (tables, mesh, chunk_size, dsig_co):
    the tables' slabs placed on the mesh's devices once, reused by every
    call."""

    def __init__(self, tables, mesh, chunk_size, dsig_co):
        n_model = mesh.shape["model"]
        self.mesh, self.chunk_size, self.dsig_co = mesh, chunk_size, dsig_co
        self.tables = tables  # padded along phi for the model axis
        self.has_co = tables.has_co
        self.n_phi_pad = tables.co_phi.shape[0] if tables.has_co else 0
        self.n_phi_local = self.n_phi_pad // n_model
        self.n_wspd = tables.co_wspd.shape[0] if tables.has_co else 0
        self._slabs = {}

    def _dsig(self, device):
        return torch.tensor(self.dsig_co, dtype=self.tables.dtype, device=device)

    def _slab(self, device, j):
        """Model shard ``j``'s (lut, u, v) phi slab on ``device``."""
        key = (str(device), j)
        if key not in self._slabs:
            t = self.tables.to(device)
            cols = slice(j * self.n_phi_local, (j + 1) * self.n_phi_local)
            self._slabs[key] = (t.co_lut[:, :, cols].contiguous(), t.co_u[:, cols].contiguous(),
                                t.co_v[:, cols].contiguous())
        return self._slabs[key]

    def candidates(self, device, j, inc, s0, ma, mz):
        """Per pixel the minimum cost over slab ``j`` and its flat index in
        the padded (wspd, phi) grid, in the one-device op order
        ``(u + v) + sig`` (a different sum order could flip near-ties)."""
        t = self.tables.to(device)
        lut, u, v = self._slab(device, j)
        inc, s0, ma, mz = (x.to(device) for x in (inc, s0, ma, mz))
        dsig = self._dsig(device)
        mz_eff = torch.abs(mz) if t.phi_180 else mz
        vals, flats = [], []
        for lo in range(0, inc.shape[0], self.chunk_size):
            sl = slice(lo, lo + self.chunk_size)
            i_inc = _nearest_index(t.co_inc, inc[sl])
            jwind = ((u - ma[sl, None, None]) / D_ANTENNA) ** 2 \
                + ((v - mz_eff[sl, None, None]) / D_AZI) ** 2
            jsig = ((lut[i_inc] - s0[sl, None, None]) / dsig) ** 2
            cost = (jwind + jsig).reshape(jwind.shape[0], -1)
            flat = _first_argmin(cost, -1)
            vals.append(cost.gather(1, flat[:, None])[:, 0])
            row = torch.div(flat, self.n_phi_local, rounding_mode="floor")
            col = flat % self.n_phi_local + j * self.n_phi_local
            flats.append(row * self.n_phi_pad + col)
        return torch.cat(vals), torch.cat(flats)

    def finish(self, device, cands, inc, s0_co, s0_cr, dsig_cr, anc_re, anc_im):
        """The combine over the model shards' candidates, the decode and the
        exact path's postprocess, on the data shard's first device."""
        t = self.tables.to(device)
        nan = torch.full_like(inc, float("nan"))
        if self.has_co:
            vals = torch.stack([c[0].to(device) for c in cands])  # (n_model, px)
            flats = torch.stack([c[1].to(device) for c in cands])
            best = vals.amin(0)  # NaN if any shard's minimum is NaN
            best_flat = torch.where(vals == best, flats, _NAN_FLAT).amin(0)
            # the reference decodes by gathers, which clip the sentinel's row
            row = torch.div(best_flat, self.n_phi_pad, rounding_mode="floor")
            wspd_co = t.co_wspd[row.clamp(max=self.n_wspd - 1)]
            phi_co = _disambiguate_phi(t, t.co_phir[best_flat % self.n_phi_pad], anc_re, anc_im)
        else:
            wspd_co = phi_co = nan
        return _postprocess_pixel(t, inc, s0_co, s0_cr, dsig_cr, anc_re, anc_im, wspd_co, phi_co)

    def __call__(self, arrs):
        mesh = self.mesh
        n_data, n_model = mesh.shape["data"], mesh.shape["model"]
        shard = arrs[0].shape[0] // n_data
        dtype = self.tables.dtype

        def inputs(i, device):
            return [staging.to_device(a[i * shard:(i + 1) * shard], device, dtype) for a in arrs]

        cands = [[None] * n_model for _ in range(n_data)]
        if self.has_co:
            def cand(i, j):
                dev = mesh.devices[i][j]
                inc, s0, _, _, ma, mz = inputs(i, dev)
                return self.candidates(dev, j, inc, s0, ma, mz)

            flat = run_on_devices([(mesh.devices[i][j], partial(cand, i, j))
                                   for i in range(n_data) for j in range(n_model)])
            cands = [flat[i * n_model:(i + 1) * n_model] for i in range(n_data)]

        def fin(i):
            dev = mesh.devices[i][0]
            co_re, co_im, du_re, du_im = self.finish(dev, cands[i], *inputs(i, dev))
            return _to_host_complex(co_re, co_im), _to_host_complex(du_re, du_im)

        outs = run_on_devices([(mesh.devices[i][0], partial(fin, i)) for i in range(n_data)])
        return tuple(np.concatenate(parts) for parts in zip(*outs))


def sharded_invert_pixels(tables: InversionTables, inc, s0_co_db, s0_cr_db, dsig_cr,
                          ancillary_wind, mesh, dsig_co=0.1, chunk_size=256, mode="exact"):
    """Dual-pol inversion of flat pixel arrays sharded over ``mesh``.

    Arguments as :func:`~xsarsea_tpu_torch.windspeed.inversion.invert_pixels`
    (sigma0 in dB, complex ancillary wind). ``mode="exact"`` takes any mesh;
    ``"fused"`` and ``"fused_exact"`` need ``model == 1``; ``"auto"`` resolves
    as ``invert_pixels`` does on the mesh's device. Returns complex host
    arrays ``(wind_co, wind_dual)`` of length n, bit-equal to the one-device
    result of the same mode.
    """
    mode = _resolve_sharded_mode(mode, tables, mesh)
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    n = np.shape(inc)[0]
    anc = np.asarray(ancillary_wind)
    streams = (inc, s0_co_db, s0_cr_db, dsig_cr, anc.real,
               anc.imag if np.iscomplexobj(anc) else np.zeros_like(anc))
    np_dtype = staging.np_dtype(tables.dtype)
    if mode in _FUSED_MODES:
        arrs = _padded_host(streams, n + (-n) % n_data, np_dtype)
        return _sharded_fused(tables, arrs, n, mesh, dsig_co, chunk_size, mode)

    # the padded tables and the placed program live on the caller's tables
    cache = tables._invert_fn_cache
    pad_key = ("padded_model", n_model)
    if pad_key not in cache:
        cache[pad_key] = pad_tables_for_model_axis(tables, n_model)
    padded, _ = cache[pad_key]
    fn_key = ("sharded_exact", mesh, chunk_size, float(dsig_co))
    if fn_key not in cache:
        cache[fn_key] = _ShardedExact(padded, mesh, chunk_size, float(dsig_co))
    lane = n_data * chunk_size
    wind_co, wind_dual = cache[fn_key](_padded_host(streams, n + (-n) % lane, np_dtype))
    return wind_co[:n], wind_dual[:n]
