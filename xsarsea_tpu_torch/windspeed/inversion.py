"""Bayesian wind inversion from sigma0 (counterpart of
``xsarsea_tpu.windspeed.inversion``).

Per pixel (reference windspeed.py:183-282):

* copol: select the nearest-incidence LUT slice, minimize
  ``J = ((u - u_anc)/2)^2 + ((v - v_anc)/2)^2 + ((lut_dB - sigma0_dB)/dsig_co)^2``
  over the (wspd, phi) grid; for symmetric (0..180 deg) LUTs resolve the
  +-phi ambiguity against the ancillary direction.
* crosspol: 1-D minimization over wspd of
  ``((lut_dB - sigma0_dB)/dsig_cr)^2 + ((wspd - |wind_co|)/2)^2`` (the prior
  only where a copol solution exists); direction taken from copol.
* NaN semantics: NaN incidence -> all NaN; valid copol sigma0 with NaN
  ancillary -> NaN.

Modes:

* ``"exact"`` — full-grid argmin per pixel, any device, float32 or float64;
  numpy's first-minimum rule (a NaN cost wins, as ``np.argmin``).
* ``"fused"`` — pixels bucketed by incidence band, a coarse group argmin
  (kernel K1), a re-bucketing by (band, wspd group), and a fused slab
  refine + decode + crosspol argmin (kernel K2), in float32. When the
  crosspol LUT has its own incidence axis (LUTs from different sources),
  the tail is unfused instead: a slab refine emitting the winner's index
  (K3), its decode in pixel order, and a crosspol argmin re-bucketed by the
  crosspol axis (K4). On a CUDA device the kernels are the hand-written
  ones of :mod:`xsarsea_tpu_torch.ops.inversion_kernels`; on the CPU their
  plain PyTorch versions run.
* ``"fused_exact"`` — the fused pipeline with its first pass on the full
  (wspd, phi) grid instead of the coarse one (K1 streams the band's grid
  through shared memory), and the refine on a 32-row slab around the group
  it finds (the reference's ``pallas_exact``): the fused mode's ground
  truth, ~4x slower; ``scripts/sweep_margin.py`` holds the coarse pass's
  spacing and margin against it.
* ``"auto"`` — ``"fused"`` on a CUDA device when the tables have a copol
  LUT, ``"exact"`` otherwise. The fused modes can differ from ``"exact"``
  on near-tie pixels (their cost multiplies by ``1/dsig`` where ``"exact"``
  divides): callers that need run-to-run identity with ``"exact"`` pass
  ``mode="exact"``.

``invert_from_model`` takes and returns ``xarray.DataArray``-like objects
through :func:`xsarsea_tpu_torch.interop.xarray_io`. Scenes larger than a
piece stream through three overlapped lanes (``_invert_source``). Several
devices, and batches of scenes: :mod:`xsarsea_tpu_torch.parallel`.
"""

from __future__ import annotations

import copy
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray, is_chunked
from xsarsea_tpu_torch.interop import xarray_io
from xsarsea_tpu_torch.models.base import get_model
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.bucketing import (
    _f32_sort_key_np,
    band_boundaries_f32,
    band_of_value,
    bucket_by_band,
    bucket_by_band_sorted,
    bucket_by_value,
    nearest_index_sorted,
    sorted_grid_form,
)
from xsarsea_tpu_torch.utils import logger, staging, timing
from xsarsea_tpu_torch.utils.spans import call, count, span
from xsarsea_tpu_torch.windspeed.dsig import (check_dsig_name, dsig_formula, nesz_expand,
                                              nesz_row_fit)

__all__ = ["invert_from_model", "invert_pixels", "InversionTables", "prepare_tables"]

# cost-function constants (reference windspeed.py:139-141)
D_ANTENNA = 2.0
D_AZI = 2.0
DWSPD_FG = 2.0

# coarse grid of the fused path's first pass, in physical units (~0.8 m/s
# in wspd, ~4 deg in phi), and the margin in wspd rows of the slab around the
# coarse winner's group (WGROUP + 2 * margin rows, starting margin rows below
# it): the values the reference tuned (xsarsea_tpu/windspeed/inversion.py:
# 483-514), which scripts/sweep_margin.py holds against the fused_exact mode.
# Module knobs: the closures are cached under their values.
_COARSE_DW = 0.8
_COARSE_DPHI = 4.0
_COARSE_MARGIN = K.SLAB_MARGIN
_FUSED_MODES = ("fused", "fused_exact")

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _np_dtype(dtype):
    try:
        return _NP_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"tables dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}") from None


class InversionTables:
    """LUT tables prepared for the inversion.

    The copol LUT is (incidence, wspd, phi) in dB with precomputed
    wind-component grids; crosspol is (incidence, wspd) in dB. Fields are
    host numpy arrays; :meth:`to` gives a device copy (cached per device).
    """

    _CO_FIELDS = ("co_lut", "co_inc", "co_wspd", "co_phi", "co_u", "co_v", "co_phir")
    _CR_FIELDS = ("cr_lut", "cr_inc", "cr_wspd")

    def __init__(self, lut_co_db=None, lut_cr_db=None, dtype=torch.float32):
        co = cr = None
        if lut_co_db is not None:
            if np.ndim(lut_co_db.data) != 3:
                raise ValueError(
                    "copol model LUT must be 3-D (incidence, wspd, phi); got "
                    f"{tuple(np.shape(lut_co_db.data))} — was a crosspol "
                    "(phi-independent) model passed as the copol model?")
            c = lut_co_db.coords
            co = (lut_co_db.data, c["incidence"], c["wspd"], c["phi"])
        if lut_cr_db is not None:
            if np.ndim(lut_cr_db.data) != 2:
                raise ValueError(
                    "crosspol model LUT must be 2-D (incidence, wspd); got "
                    f"{tuple(np.shape(lut_cr_db.data))} — was a copol "
                    "(phi-dependent) model passed as the crosspol model?")
            c = lut_cr_db.coords
            cr = (lut_cr_db.data, c["incidence"], c["wspd"])
        self._set_fields(co, cr, dtype)

    @classmethod
    def from_arrays(cls, co_lut=None, co_inc=None, co_wspd=None, co_phi=None, cr_lut=None,
                    cr_inc=None, cr_wspd=None, dtype=torch.float32):
        """Tables from plain arrays, e.g. the fields of another package's
        tables. The wind-component grids are computed from ``co_wspd`` and
        ``co_phi`` in float64, as the constructor does from LUT coords: pass
        the coordinates at full precision to reproduce them bit for bit."""
        obj = object.__new__(cls)
        co = None if co_lut is None else (co_lut, co_inc, co_wspd, co_phi)
        cr = None if cr_lut is None else (cr_lut, cr_inc, cr_wspd)
        obj._set_fields(co, cr, dtype)
        return obj

    def _set_fields(self, co, cr, dtype):
        np_dtype = _np_dtype(dtype)
        self.dtype = dtype
        self.has_co = co is not None
        self.has_cr = cr is not None
        if self.has_co:
            lut, inc, wspd, phi = co
            self.co_lut = np.ascontiguousarray(np.asarray(lut), dtype=np_dtype)
            self.co_inc = np.asarray(inc, dtype=np_dtype)
            wspd = np.asarray(wspd, dtype=np.float64)
            phi = np.asarray(phi, dtype=np.float64)
            self.co_wspd = wspd.astype(np_dtype)
            self.co_phi = phi.astype(np_dtype)
            # symmetric LUT detection (windspeed.py:152-156); also True for
            # a full 0..360 span, as the reference rule
            self.phi_180 = bool((180.0 - (phi[-1] - phi[0])) < 2.0)
            phir = np.deg2rad(phi)
            self.co_u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np_dtype)
            self.co_v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np_dtype)
            self.co_phir = phir.astype(np_dtype)
        if self.has_cr:
            lut, inc, wspd = cr
            self.cr_lut = np.ascontiguousarray(np.asarray(lut), dtype=np_dtype)
            self.cr_inc = np.asarray(inc, dtype=np_dtype)
            self.cr_wspd = np.asarray(wspd, dtype=np_dtype)
        self._device_copies = {}
        self._invert_fn_cache = {}

    def to(self, device):
        """Device copy of every field as tensors (cached per device)."""
        device = torch.device(device)
        key = str(device)
        if key not in self._device_copies:
            dev = copy.copy(self)
            dev._device_copies, dev._invert_fn_cache = {}, {}
            fields = (self._CO_FIELDS if self.has_co else ()) + (
                self._CR_FIELDS if self.has_cr else ())
            for f in fields:
                arr = np.require(getattr(self, f), requirements=["C", "W"])
                setattr(dev, f, torch.as_tensor(arr, device=device))
            self._device_copies[key] = dev
        return self._device_copies[key]


@lru_cache(maxsize=32)
def _cached_tables(model_co_name, model_cr_name, dtype, kwargs_key):
    count("builds")
    with span("xs.build"):
        kwargs = dict(kwargs_key)
        lut_co = get_model(model_co_name).to_lut(units="dB", **kwargs) if model_co_name else None
        lut_cr = get_model(model_cr_name).to_lut(units="dB", **kwargs) if model_cr_name else None
        return InversionTables(lut_co, lut_cr, dtype=dtype)


def prepare_tables(model_co=None, model_cr=None, dtype=torch.float32, **kwargs):
    """Build (and cache) InversionTables for the given models."""
    def hashable(v):
        return tuple(v) if isinstance(v, (list, np.ndarray)) else v

    with span("xs.tables"):
        return _cached_tables(
            get_model(model_co).name if model_co is not None else None,
            get_model(model_cr).name if model_cr is not None else None,
            dtype,
            tuple(sorted((k, hashable(v)) for k, v in kwargs.items())),
        )


# ------------------------------------------------------------- exact path

def _first_argmin(x, dim=-1):
    """``np.argmin`` along ``dim``: the first NaN if the slice holds one,
    else the first minimum."""
    isn = torch.isnan(x)
    first_nan = torch.argmax(isn.to(torch.int32), dim)  # argmax: first maximum
    first_min = torch.argmin(torch.where(isn, float("inf"), x), dim)
    return torch.where(isn.any(dim), first_nan, first_min)


def _wrap_angle(a):
    """wrap to (-pi, pi], like np.angle of a unit complex."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def _nearest_index(axis, values):
    """First-minimum nearest index per value, matching np.argmin(|axis - v|)."""
    return _first_argmin(torch.abs(axis - values[:, None]), -1)


def _copol_solution(t, i_inc, s0_co_db, ma, mz, dsig_co):
    """Copol cost minimization for a batch of pixels -> (wspd, phi_signed_rad)."""
    lut_inc = t.co_lut[i_inc]  # (C, W, P)
    mz_eff = torch.abs(mz) if t.phi_180 else mz
    jwind = ((t.co_u - ma[:, None, None]) / D_ANTENNA) ** 2 \
        + ((t.co_v - mz_eff[:, None, None]) / D_AZI) ** 2
    jsig = ((lut_inc - s0_co_db[:, None, None]) / dsig_co) ** 2
    j = jwind + jsig
    n_phi = j.shape[-1]
    flat = _first_argmin(j.reshape(j.shape[0], -1), -1)
    wspd = t.co_wspd[torch.div(flat, n_phi, rounding_mode="floor")]
    phir = t.co_phir[flat % n_phi]
    return wspd, _disambiguate_phi(t, phir, ma, mz)


def _disambiguate_phi(t, phir, ma, mz):
    """+-phi ambiguity for symmetric LUTs: the sign closest to the
    ancillary direction (windspeed.py:234-245)."""
    if not t.phi_180:
        return phir
    anc_ang = torch.atan2(mz, ma)
    d1 = torch.abs(_wrap_angle(anc_ang - phir))
    d2 = torch.abs(_wrap_angle(anc_ang + phir))
    return torch.where(d1 <= d2, phir, -phir)


def _crosspol_solution(t, i_inc_cr, s0_cr_db, dsig_cr, wspd_co):
    """Crosspol 1-D cost minimization for a batch of pixels -> wspd_dual."""
    lut_inc = t.cr_lut[i_inc_cr]  # (C, Wc)
    jsig = ((lut_inc - s0_cr_db[:, None]) / dsig_cr[:, None]) ** 2
    jwind = ((t.cr_wspd - wspd_co[:, None]) / DWSPD_FG) ** 2
    has_co = ~torch.isnan(wspd_co)
    j = jsig + torch.where(has_co[:, None], jwind, 0.0)
    return t.cr_wspd[_first_argmin(j, -1)]


def _postprocess_pixel(t, inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, wspd_co, phi_co):
    """Masking, crosspol and NaN guards of the exact path, with the
    reference's guard order (windspeed.py:198-207)."""
    nan = float("nan")
    if t.has_co:
        co_valid = ~torch.isnan(s0_co_db)
        wspd_co = torch.where(co_valid, wspd_co, nan)
        phi_co = torch.where(co_valid, phi_co, nan)
    co_re = wspd_co * torch.cos(phi_co)
    co_im = wspd_co * torch.sin(phi_co)

    if t.has_cr:
        i_inc_cr = _nearest_index(t.cr_inc, inc)
        wspd_dual = _crosspol_solution(t, i_inc_cr, s0_cr_db, dsig_cr, wspd_co)
        phi_dual = torch.where(~torch.isnan(wspd_co), phi_co, 0.0)
        cr_valid = (~torch.isnan(s0_cr_db)) & (~torch.isnan(dsig_cr))
        dual_re = torch.where(cr_valid, wspd_dual * torch.cos(phi_dual), nan)
        dual_im = torch.where(cr_valid, wspd_dual * torch.sin(phi_dual), nan)
    else:
        dual_re = dual_im = torch.full_like(inc, nan)

    # guard 1: NaN incidence -> all NaN; guard 2: valid copol sigma0 but NaN
    # ancillary -> all NaN. The reference assigns the real np.nan on guards
    # (-> nan+0j) vs nan*1j (-> nan+nan.j) for missing copol.
    anc_nan = torch.isnan(anc_re) | torch.isnan(anc_im)
    guard = torch.isnan(inc) | ((~torch.isnan(s0_co_db)) & anc_nan)
    return (torch.where(guard, nan, co_re), torch.where(guard, 0.0, co_im),
            torch.where(guard, nan, dual_re), torch.where(guard, 0.0, dual_im))


def _invert_chunk(t, inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, dsig_co):
    if t.has_co:
        i_inc = _nearest_index(t.co_inc, inc)
        wspd_co, phi_co = _copol_solution(t, i_inc, s0_co_db, anc_re, anc_im, dsig_co)
    else:
        wspd_co = phi_co = torch.full_like(inc, float("nan"))
    return _postprocess_pixel(t, inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im,
                              wspd_co, phi_co)


def _make_exact_fn(tables, chunk_size, device):
    """Exact-path inversion over flat pixel tensors, ``chunk_size`` pixels
    at a time (each pixel reads a whole (W, P) LUT plane)."""
    tdev = tables.to(device)

    def run(inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, dsig_co):
        n = inc.shape[0]
        outs = [torch.empty_like(inc) for _ in range(4)]
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            res = _invert_chunk(tdev, *(a[lo:hi] for a in (inc, s0_co_db, s0_cr_db, dsig_cr,
                                                             anc_re, anc_im)), dsig_co)
            for o, r in zip(outs, res):
                o[lo:hi] = r
        return tuple(outs)

    return run


# ------------------------------------------------------------- fused path

def _rebucket_slot(perm, gstar, band_of_block, *, n_inc, n_wgroups, block, slab_block):
    """Re-bucket stage-1 slots by (band, wspd group), carrying the stage-1
    permutation as payload (no scatter back to pixel order first). The key is
    int32, below ``n_inc * n_wgroups + 1``: the sort covers its bit length."""
    valid = perm >= 0
    band_slot = band_of_block.to(torch.int32)[:, None].expand(-1, block).reshape(-1)
    key_slot = torch.where(valid, band_slot * n_wgroups + gstar.to(torch.int32),
                           n_inc * n_wgroups)
    return bucket_by_band(key_slot, n_bands=n_inc * n_wgroups, block=slab_block, values=perm)


def _postprocess_vectorized(inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, wspd_co_raw,
                            cos_p, sin_p, phir_sol, wspd_dual, *, phi_180, has_cr):
    """Fused-path postprocess: the +-phi disambiguation with
    ``_disambiguate_phi``'s exact fp sequence (atan2 + trig wrap +
    ``d1 <= d2``; the flip negates only the sine), then the NaN guards."""
    co_valid = ~torch.isnan(s0_co_db)
    nan = float("nan")
    if phi_180:
        anc_ang = torch.atan2(anc_im, anc_re)
        d1 = torch.abs(_wrap_angle(anc_ang - phir_sol))
        d2 = torch.abs(_wrap_angle(anc_ang + phir_sol))
        sin_co = torch.where(d1 <= d2, sin_p, -sin_p)
    else:
        sin_co = sin_p
    wspd_co = torch.where(co_valid, wspd_co_raw, nan)
    co_re = wspd_co * cos_p
    co_im = wspd_co * sin_co

    if has_cr:
        # phi_dual = phi_co where copol solved, else 0 (cos 1, sin 0)
        has_co = ~torch.isnan(wspd_co)
        cr_valid = (~torch.isnan(s0_cr_db)) & (~torch.isnan(dsig_cr))
        dual_re = torch.where(cr_valid, wspd_dual * torch.where(has_co, cos_p, 1.0), nan)
        dual_im = torch.where(cr_valid, wspd_dual * torch.where(has_co, sin_co, 0.0), nan)
    else:
        dual_re = torch.full_like(co_re, nan)
        dual_im = torch.full_like(co_im, nan)

    anc_nan = torch.isnan(anc_re) | torch.isnan(anc_im)
    guard = torch.isnan(inc) | (co_valid & anc_nan)
    return (torch.where(guard, nan, co_re), torch.where(guard, 0.0, co_im),
            torch.where(guard, nan, dual_re), torch.where(guard, 0.0, dual_im))


def _make_fused_invert_fn(tables, device, coarse=True):
    """Fused inversion: bucketing, K1, re-bucketing, then K2, or (crosspol
    LUT on its own incidence axis) K3, a decode in pixel order and K4
    re-bucketed by the crosspol axis; then the vectorized postprocess
    (reference ``_make_pallas_invert_fn``, inversion.py:659-1015). The
    kernels read the pixel table through each bucket permutation and K2-K4
    write pixel order through it (``index=``): no bucket-ordered copy of the
    features or of the results is made.

    ``coarse``: K1 on the coarse grid (``_COARSE_DW`` x ``_COARSE_DPHI``)
    with a ``_COARSE_MARGIN`` refine margin in wspd rows (a multiple of 8, as
    the reference's), or on the full grid with ``K.EXACT_SLAB_MARGIN`` (the
    fused_exact mode).
    """
    if not tables.has_co:
        raise ValueError("the fused inversion needs a copol LUT; use mode='exact'")
    margin = _COARSE_MARGIN if coarse else K.EXACT_SLAB_MARGIN
    if margin < 0 or margin % 8:
        raise ValueError(f"the refine margin must be a multiple of 8 rows, got {margin}")
    slab_rows = K.WGROUP + 2 * margin
    dev = torch.device(device)
    f32 = torch.float32
    co_wspd = np.asarray(tables.co_wspd, np.float64)
    co_phi = np.asarray(tables.co_phi, np.float64)
    step_w = float(np.median(np.diff(co_wspd)))
    step_p = float(np.median(np.diff(co_phi)))
    lut = np.asarray(tables.co_lut, np.float32)
    u = np.asarray(tables.co_u, np.float32)
    v = np.asarray(tables.co_v, np.float32)
    lut_c, u_c, v_c, row_group, n_wgroups = K.build_coarse_arrays(
        lut, u, v, stride_w=max(1, round(_COARSE_DW / step_w)) if coarse else 1,
        stride_p=max(1, round(_COARSE_DPHI / step_p)) if coarse else 1)
    lut_pad, u_pad, v_pad = K.build_direct_arrays(lut, u, v)
    n_inc, wp_rows, n_phi = lut_pad.shape
    n_wspd = co_wspd.shape[0]
    w_pad = K.build_decode_arrays(tables.co_wspd, wp_rows)

    def to_dev(a):
        return torch.as_tensor(a, device=dev)

    k1_ops = tuple(to_dev(a) for a in (lut_c, u_c, v_c, row_group))
    # K1 holds a grid that fits a block's shared memory whole, and streams
    # one that does not (the full grid of the fused_exact mode) with the
    # chunks' annuli of its lower bound; its row groups are checked here once
    k1_kw = {"block": K.GROUP_BLOCK}
    k1_name = "group_argmin"
    if not K.k1_staged_fits(*u_c.shape):
        k1_name = "group_argmin_streamed"
        k1_kw["radii"] = to_dev(K.build_chunk_radii(u_c, v_c))
    K.check_row_group(k1_ops[3], n_wgroups)
    direct = tuple(to_dev(a) for a in (lut_pad, u_pad, v_pad, w_pad))
    co_phir = to_dev(np.asarray(tables.co_phir, np.float32))
    has_cr = tables.has_cr
    # K2 fuses the crosspol argmin into the slab refine when both LUTs share
    # the incidence axis (its blocks are single-band); otherwise the tail is
    # unfused (K3, decode, K4 over crosspol-band buckets)
    fused_tail = not has_cr or np.array_equal(np.asarray(tables.co_inc, np.float64),
                                              np.asarray(tables.cr_inc, np.float64))
    if has_cr:
        cr_ops = tuple(to_dev(a) for a in K.build_crosspol_arrays(tables.cr_lut,
                                                                  tables.cr_wspd))
        cr_grid = to_dev(np.asarray(tables.cr_inc, np.float64).astype(np.float32))
        cr_form = sorted_grid_form(cr_grid)  # read once: no host copy a piece
    else:  # never read by K2 with has_cr=False
        cr_ops = (torch.zeros((1, 1), dtype=f32, device=dev),
                  torch.zeros((1,), dtype=f32, device=dev))
    # nearest incidence band fused into the bucket sort through exact f32
    # decision boundaries (bucket_by_value); non-f32 input or a grid without
    # such boundaries takes the per-pixel nearest pass instead
    bounds = band_boundaries_f32(np.asarray(tables.co_inc, np.float32))
    boundary_keys = None if bounds is None else to_dev(_f32_sort_key_np(bounds))
    inc_grid = to_dev(np.asarray(tables.co_inc, np.float64).astype(np.float32))
    inc_form = sorted_grid_form(inc_grid)
    phi_180 = tables.phi_180
    block = K.GROUP_BLOCK
    nan = float("nan")

    def run(inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, dsig_co):
        with span("xs.bucket"):
            n = inc.shape[0]
            mz = torch.abs(anc_im) if phi_180 else anc_im
            cols = [s0_co_db.to(f32), anc_re.to(f32) * 0.5, mz.to(f32) * 0.5,
                    (1.0 / dsig_co).to(f32).expand(n)]
            if fused_tail:  # K2's crosspol columns
                zero = torch.zeros(n, dtype=f32, device=inc.device)
                cols += [s0_cr_db.to(f32) if has_cr else zero, dsig_cr.to(f32) if has_cr else zero,
                         zero, zero]
            pix = torch.stack(cols, dim=1)
            by_value = boundary_keys is not None and inc.dtype == f32
            if coarse and by_value:
                perm, band_of_block = bucket_by_value(inc, boundary_keys, n_inc, block)
            else:
                band = band_of_value(inc, boundary_keys) if by_value \
                    else nearest_index_sorted(inc_grid, inc, form=inc_form)
                if coarse:
                    perm, band_of_block = bucket_by_band(band, n_inc, block)
                else:
                    # fused_exact: each band's pixels in ascending order of their
                    # prior's radius |(ma/2, mz/2)|, so that a block's priors lie
                    # close and K1's streamed form sweeps few groups for it
                    perm, band_of_block = bucket_by_band_sorted(
                        band, torch.hypot(pix[:, 1], pix[:, 2]), n_inc, block)
            # the indices the kernels dereference are built in range here (a
            # bucketing's block bands lie below its band count, the slab rows
            # are clamped): marked, the wrappers launch without reading them
            # back, and the host enqueues the whole piece without a wait
            K.mark_in_range(band_of_block, 0, n_inc)

        with span("xs.coarse"):
            # stage 1: coarse group argmin per incidence-band block (K1), each
            # slot's features (pix's first 4 columns) read through perm
            gstar = getattr(K, k1_name)(*k1_ops, pix, band_of_block, n_wgroups, index=perm,
                                        **k1_kw).reshape(-1)

        with span("xs.rebucket"):
            # stage 2: re-bucket by (band, group) for the slab refine
            perm2, key_of_block = _rebucket_slot(perm, gstar, band_of_block, n_inc=n_inc,
                                                 n_wgroups=n_wgroups, block=block,
                                                 slab_block=K.SLAB_BLOCK)
            # every pixel id sits in exactly one slot of perm2, -1 marks padding
            sband = torch.div(key_of_block, n_wgroups, rounding_mode="floor")
            srow0 = torch.clamp((key_of_block % n_wgroups) * K.WGROUP - margin, 0,
                                wp_rows - slab_rows)
            K.mark_in_range(sband, 0, n_inc)  # key_of_block < n_inc * n_wgroups
            K.mark_in_range(srow0, 0, wp_rows - slab_rows + 1)
            vmask = (perm2 >= 0).reshape(-1, K.SLAB_BLOCK).any(dim=1)

        with span("xs.refine"):
            if fused_tail:
                # slab refine + decode + crosspol (K2), written in pixel order
                res = K.slab_refine_fused(*direct, co_phir, *cr_ops, pix, sband, srow0, vmask,
                                          has_cr=has_cr, block=K.SLAB_BLOCK, n_rows=slab_rows,
                                          index=perm2)
                wspd_co_raw, phir_sol, wspd_dual = res[0], res[1], res[2] if has_cr else None
            else:
                # slab refine emitting the winner's index (K3) in pixel order,
                # decoded there; the reference clips its sentinels to the last
                # grid cell (inversion.py:940-946)
                flat = K.slab_refine(*direct[:3], pix, sband, srow0, vmask, block=K.SLAB_BLOCK,
                                     n_rows=slab_rows, index=perm2)
                flat = flat.to(torch.int64).clamp(0, n_wspd * n_phi - 1)
                wspd_co_raw = direct[3][torch.div(flat, n_phi, rounding_mode="floor")]
                phir_sol = co_phir[flat % n_phi]

                # stage 3: re-bucket by crosspol incidence band, crosspol argmin
                # (K4) with the copol speed as prior where copol solved
                # (inversion.py:949-981; its same-axis branch cannot occur here,
                # the tail runs only when the axes differ)
                wspd_co_m = torch.where(torch.isnan(s0_co_db), nan, wspd_co_raw)
                has_co = (~torch.isnan(wspd_co_m)).to(f32)
                perm3, band3 = bucket_by_band(nearest_index_sorted(cr_grid, inc, form=cr_form),
                                              cr_grid.shape[0], K.CR_BLOCK)
                K.mark_in_range(band3, 0, cr_grid.shape[0])
                pix3 = torch.stack([s0_cr_db.to(f32), dsig_cr.to(f32),
                                    torch.where(has_co > 0, wspd_co_m, 0.0) * 0.5, has_co], dim=1)
                wspd_dual = K.crosspol_argmin(*cr_ops, pix3, band3, block=K.CR_BLOCK, index=perm3)

        with span("xs.post"):
            return _postprocess_vectorized(
                inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, wspd_co_raw,
                torch.cos(phir_sol), torch.sin(phir_sol), phir_sol, wspd_dual,
                phi_180=phi_180, has_cr=has_cr)

    return run


def _resolve_mode(mode, tables, device):
    if mode == "auto":
        return "fused" if torch.device(device).type == "cuda" and tables.has_co else "exact"
    if mode != "exact" and mode not in _FUSED_MODES:
        raise ValueError(f"unknown inversion mode '{mode}'")
    return mode


def _get_invert_fn(tables, chunk_size, mode, device):
    """The inversion closure for (tables, mode, device), cached on the
    tables. The fused modes' key holds the sweepable knobs, so a changed
    knob is never served a closure built under the old value (the
    reference's key, inversion.py:1085-1091)."""
    if mode == "exact":
        key = (mode, str(torch.device(device)), chunk_size)
    else:
        key = (mode, str(torch.device(device)), _COARSE_DW, _COARSE_DPHI, _COARSE_MARGIN)
    cache = tables._invert_fn_cache
    with span("xs.tables"):
        if key not in cache:
            count("builds")
            with span("xs.build"):
                if mode == "exact":
                    cache[key] = _make_exact_fn(tables, chunk_size, device)
                else:
                    cache[key] = _make_fused_invert_fn(tables, device, coarse=mode == "fused")
        return cache[key]


# ------------------------------------------------------ streamed piece source

def _flat_slice(arr, shape, lo, hi):
    """Flat row-major [lo, hi) of ``arr`` as a 1-D array or tensor.

    Contiguous arrays and tensors are sliced as views (a C-contiguous
    ``np.memmap`` too: its pages are read where the view is read); anything
    else with numpy-style first-axis slicing (chunked stores, broadcast
    views) goes through the rows covering [lo, hi), so only O(piece)
    elements are materialized.
    """
    if isinstance(arr, torch.Tensor):
        return arr.reshape(-1)[lo:hi]
    if isinstance(arr, np.ndarray) and arr.flags.c_contiguous:
        return arr.reshape(-1)[lo:hi]
    rest = 1
    for s in shape[1:]:
        rest *= int(s)
    r0, r1 = lo // rest, -(-hi // rest)
    block = np.ascontiguousarray(np.asarray(arr[r0:r1])).reshape(-1)
    return block[lo - r0 * rest: hi - r0 * rest]


def _real_imag(a):
    if isinstance(a, torch.Tensor):
        return (a.real, a.imag) if a.is_complex() else (a, torch.zeros_like(a))
    a = np.asarray(a)
    return a.real, (a.imag if np.iscomplexobj(a) else np.zeros_like(a))


class _PreparedSource:
    """Piece source over flat, already-dB arrays or tensors (invert_pixels)."""

    def __init__(self, inc, s0_co_db, s0_cr_db, dsig_cr, anc):
        self.n = int(inc.shape[0])
        self._arrs = (inc, s0_co_db, s0_cr_db, dsig_cr, *_real_imag(anc))

    def resident(self, device):
        """True when every array already is a tensor on ``device``: a piece
        is then a view, and there is no preparation to overlap."""
        return all(isinstance(a, torch.Tensor) and a.device.type == device.type
                   and device.index in (None, a.device.index) for a in self._arrs)

    def streams(self, lo, hi, device, dtype):
        return [staging.to_device(a[lo:hi], device, dtype) for a in self._arrs]


class _NeszWeights:
    """The crosspol channel's ``dsig_cr`` from its raw NESZ, as xsarsea's L1
    example makes it (``nesz_flattening``, then ``get_dsig``), for the pieces
    of one scene: the scene-wide pass's results on the device, in float64.

    ``slope``, ``intercept``: each row's line (:func:`nesz_row_fit`);
    ``inc_1d``: the incidence's column means; ``inc``: the flat scene
    incidence in its own float dtype, or None when the incidence is a
    ``(nx,)`` vector (then ``inc_1d`` is that vector); ``rows_nan``: a device
    count of the rows left without a line.
    """

    def __init__(self, scheme, slope, intercept, inc_1d, inc):
        self.scheme, self.slope, self.intercept = scheme, slope, intercept
        self.inc_1d, self.inc = inc_1d, inc
        self.rows_nan = torch.isnan(slope + intercept).sum()

    def dsig(self, lo, hi, s0_cr):
        """``dsig_cr`` of the flat range ``[lo, hi)``, from the linear crosspol
        sigma0 ``s0_cr`` of those pixels, in float64."""
        nesz = nesz_expand(self.slope, self.intercept, self.inc_1d, lo, hi)
        if self.inc is None:
            cols = torch.arange(lo, hi, device=nesz.device) % self.inc_1d.shape[0]
            inc = self.inc_1d[cols]
        else:
            inc = self.inc[lo:hi].to(torch.float64)
        return dsig_formula(self.scheme, inc, s0_cr.to(torch.float64), nesz)


def _float_dtype(x):
    """The float dtype that holds the values of array ``x`` (float32 at the
    least), read from its dtype alone: a chunked array is not materialized."""
    return torch.float64 if staging.torch_dtype(x.dtype) == torch.float64 else torch.float32


class _LazySource:
    """Piece source running the reference's host prep piece by piece.

    The reference converts the whole scene up front (f64 dB conversion with
    the 1e-15 clip, windspeed.py:126-130); here each piece is prepared on
    its own, so host memory stays O(piece). ``s0_co``/``s0_cr``/``anc`` may
    be None (NaN streams); ``dsig_cr`` may be a scalar or broadcastable, or
    the name of a ``get_dsig`` scheme with the raw crosspol NESZ ``nesz_cr``
    of the scene's shape: :meth:`fit_nesz` then runs the scene-wide pass once
    on the device, and each piece weights its own pixels there (``xs.dsig``).
    Incidence may be the scene shape or broadcastable to it: a scalar, a
    ``(nx,)``/``(1, nx)`` sample vector or a ``(ny, 1)`` line vector; then
    only the vector goes to the device and the flat stream is rebuilt
    there by an index gather.

    ``device_db``: sigma0 goes to the device linear and is converted to dB
    there (in the tables' dtype). The input dB then differs from host-f64
    prep at ulp scale, which can move near-tie pixels to the other of two
    near-equal minima; ``device_db=False`` keeps host prep in every mode.
    """

    def __init__(self, shape, inc, s0_co=None, s0_cr=None, dsig_cr=0.1, anc=None,
                 device_db=None, nesz_cr=None):
        self.shape = tuple(int(s) for s in shape)
        self.n = int(np.prod(self.shape, dtype=np.int64))
        self.inc, self.s0_co, self.s0_cr = inc, s0_co, s0_cr
        self.dsig_cr, self.anc = dsig_cr, anc
        self.device_db = device_db
        self.nesz_cr = nesz_cr
        self._weights = None
        self.inc_mode = "full"
        self._inc_div = 1
        inc_shape = tuple(int(s) for s in np.shape(inc))
        if inc_shape != self.shape:
            if inc_shape in ((), (1,)):
                self.inc_mode, self._inc_div = "sample", 1
            elif len(self.shape) == 2 and inc_shape in ((self.shape[1],), (1, self.shape[1])):
                self.inc_mode, self._inc_div = "sample", self.shape[1]
            elif len(self.shape) == 2 and inc_shape == (self.shape[0], 1):
                self.inc_mode, self._inc_div = "line", self.shape[1]
            else:
                raise ValueError(
                    f"incidence shape {inc_shape} is neither the scene shape {self.shape} "
                    "nor broadcastable to it as a scalar, (nx,)/(1, nx) sample vector or "
                    "(ny, 1) line vector")
            if s0_co is None and s0_cr is None:
                raise ValueError("broadcastable incidence requires a sigma0 stream")
            self._inc_vec = np.ascontiguousarray(np.asarray(inc, dtype=np.float64).reshape(-1))
        if isinstance(dsig_cr, str) or nesz_cr is not None:
            self._check_nesz()

    def _check_nesz(self):
        if not isinstance(self.dsig_cr, str) or self.nesz_cr is None:
            raise ValueError("dsig_cr from the crosspol NESZ takes both a dsig scheme name "
                             "(dsig_cr=) and the raw linear NESZ (nesz_cr=)")
        check_dsig_name(self.dsig_cr)
        if self.s0_cr is None:
            raise ValueError("dsig_cr from the NESZ needs the crosspol sigma0")
        if len(self.shape) != 2 or tuple(np.shape(self.nesz_cr)) != self.shape:
            raise ValueError(f"nesz_cr must have the (line, sample) shape of the scene "
                             f"{self.shape}, got {tuple(np.shape(self.nesz_cr))}")
        if not (self.inc_mode == "full" or (self.inc_mode == "sample" and self._inc_div > 1)):
            raise ValueError("the NESZ flattening fits incidence along the samples: give it as "
                             "the scene array or an (nx,)/(1, nx) sample vector")

    def _whole(self, arr, device):
        """The flat scene of a source array on ``device``, in its own float
        dtype, staged in blocks so that the pinned buffers stay small."""
        dtype = _float_dtype(arr)
        step = 1 << 23
        parts = [staging.to_device(self._read(arr, lo, min(lo + step, self.n)), device, dtype)
                 for lo in range(0, self.n, step)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def fit_nesz(self, device):
        """The scene-wide pass of the weighting from the NESZ (span
        ``xs.nesz``): the scene's incidence and NESZ to the device, the
        incidence's column means and each row's line, in float64. The scene
        incidence stays on the device for the pieces, which take it from
        there; the NESZ is dropped once fitted. Counts ``nesz_rows``."""
        ny, nx = self.shape
        f64 = torch.float64
        inc = None
        if self.inc_mode == "full":
            inc = self._whole(self.inc, device)
            inc_1d = torch.nanmean(inc.view(ny, nx).to(f64), dim=0)
        else:
            inc_1d = staging.to_device(self._inc_vec, device, f64)
        noise = self._whole(self.nesz_cr, device).view(ny, nx).to(f64)
        slope, intercept = nesz_row_fit(noise, inc_1d)
        self._weights = _NeszWeights(self.dsig_cr, slope, intercept, inc_1d, inc)
        count("nesz_rows", ny)

    def rows_nan(self):
        """Rows the NESZ fit left without a line (a read of the device's count)."""
        return int(self._weights.rows_nan)

    def _read(self, arr, lo, hi):
        """Flat [lo, hi) of a source array: the span ``xs.read`` around
        ``_flat_slice`` and the rows it materializes (a view of a memory-mapped
        file reads its pages later, in the cast), and the counter
        ``read_bytes``: the piece's bytes of a host array of the scene's own
        values, not of one broadcast to the scene (a stride of 0)."""
        with span("xs.read"):
            x = _flat_slice(arr, self.shape, lo, hi)
        on_host = not isinstance(x, torch.Tensor) or x.device.type == "cpu"
        strides = arr.stride() if isinstance(arr, torch.Tensor) else getattr(arr, "strides", ())
        if on_host and not any(s == 0 and n > 1 for s, n in zip(strides, np.shape(arr))):
            count("read_bytes", x.nbytes if isinstance(x, np.ndarray)
                  else x.numel() * x.element_size())
        return x

    def _db(self, arr, lo, hi, device, dtype):
        return self._to_db(self._read(arr, lo, hi), device, dtype)

    def _to_db(self, x, device, dtype):
        if self.device_db:  # linear to the device, log10 there
            x = staging.to_device(x, device, dtype)
            return 10.0 * torch.log10(x + 1e-15)
        if isinstance(x, torch.Tensor):
            x = staging.to_host(x)
        x = np.asarray(x, dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            x = 10.0 * np.log10(x + 1e-15)
        return staging.to_device(x, device, dtype)

    def _db_linear(self, arr, lo, hi, device, dtype):
        """A sigma0 stream in dB, as :meth:`_db` makes it, and its linear
        values on the device in their own float dtype (the dsig weighting's
        input): one copy when the dB is taken on the device."""
        x = self._read(arr, lo, hi)
        lin = staging.to_device(x, device, _float_dtype(x))
        if self.device_db:
            return 10.0 * torch.log10(lin.to(dtype) + 1e-15), lin
        return self._to_db(x, device, dtype), lin

    def streams(self, lo, hi, device, dtype):
        m = hi - lo
        weights = self._weights
        if weights is not None and weights.inc is not None:
            inc = weights.inc[lo:hi].to(dtype)
        elif self.inc_mode == "full":
            inc = staging.to_device(self._read(self.inc, lo, hi), device, dtype)
        else:
            vec = staging.to_device(self._inc_vec, device, dtype)
            idx = lo + torch.arange(m, device=device)
            pos = idx % self._inc_div if self.inc_mode == "sample" else idx // self._inc_div
            inc = vec[pos]
        nanv = torch.full((m,), float("nan"), dtype=dtype, device=device)
        s0_co = nanv if self.s0_co is None else self._db(self.s0_co, lo, hi, device, dtype)
        if weights is None:
            s0_cr = nanv if self.s0_cr is None else self._db(self.s0_cr, lo, hi, device, dtype)
            if np.ndim(self.dsig_cr) == 0:
                dsig = torch.full((m,), float(np.asarray(self.dsig_cr)), dtype=dtype,
                                  device=device)
            else:
                d = self.dsig_cr
                if tuple(np.shape(d)) != self.shape:
                    d = np.broadcast_to(np.asarray(d), self.shape)
                dsig = staging.to_device(self._read(d, lo, hi), device, dtype)
        else:
            s0_cr, s0_cr_lin = self._db_linear(self.s0_cr, lo, hi, device, dtype)
            with span("xs.dsig"):
                dsig = weights.dsig(lo, hi, s0_cr_lin).to(dtype)
            count("dsig_px", m)
        if self.anc is None:
            anc_re = anc_im = nanv
        else:
            anc_re, anc_im = (staging.to_device(part, device, dtype) for part in
                              _real_imag(self._read(self.anc, lo, hi)))
        return [inc, s0_co, s0_cr, dsig, anc_re, anc_im]


@lru_cache(maxsize=None)
def _side_streams(device):
    """The copy-in and the copy-out stream of ``device``, made once: the
    caching allocator keeps a pool of blocks per stream, so a new stream a
    call would allocate its pieces anew every time."""
    return torch.cuda.Stream(device), torch.cuda.Stream(device)


class _Lanes:
    """The streams of the overlapped piece loop on a CUDA device: one for the
    copies in (and the device side of a piece's preparation), one for the
    copies out, beside the current stream, which runs the kernels. On the CPU,
    and for the serial loop, there are none: everything is in program order."""

    def __init__(self, device, overlap):
        self.device = device
        self.copy_in = self.copy_out = None
        if overlap and device.type == "cuda":
            self.copy_in, self.copy_out = _side_streams(device)
            # the caller's device-resident inputs may still be in the making
            self.copy_in.wait_stream(torch.cuda.current_stream(device))

    def prepare(self, source, lo, hi, dtype):
        """The piece's input tensors, made on the copy-in stream, and the
        event that says they are ready."""
        with span("xs.prep"):
            if self.copy_in is None:
                return source.streams(lo, hi, self.device, dtype), None
            with torch.cuda.stream(self.copy_in):
                tensors = source.streams(lo, hi, self.device, dtype)
                ready = torch.cuda.Event()
                ready.record()
            return tensors, ready

    def join(self, tensors, ready):
        """Make the current stream wait for a prepared piece."""
        if ready is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(ready)
        for t in tensors:
            # made on the copy-in stream, read on this one: the allocator must
            # not reuse the block before this stream is done with it
            t.record_stream(current)


def _pieces(n, piece):
    if n <= piece + (piece >> 1):
        return [(0, n)]
    return [(lo, min(lo + piece, n)) for lo in range(0, n, piece)]


def _invert_source(tables, source, dsig_co=0.1, chunk_size=256, mode="auto", device="cuda",
                   device_output=False, piece_size=None, merge=False, _overlap=True):
    """Run the inversion over a piece source.

    A scene of several pieces streams through three overlapped lanes with at
    most two pieces in flight: a worker thread prepares piece k+1 (the host's
    slicing and f64 dB conversion, the casts into pinned buffers, the copies in
    on their own stream), the calling thread runs the kernels on piece k, and
    a second worker moves the results of piece k-1, copied out on a third
    stream into pinned buffers, into the preallocated outputs. On the CPU the
    same loop runs without streams. ``_overlap=False`` runs the pieces one
    after the other on the calling thread, for the tests that hold the lanes
    to it bit for bit.

    Device residency stays O(piece) unless ``device_output=True``, which
    keeps every piece's results on the device and returns complex tensors
    (then only the preparation overlaps, and nothing does when the inputs are
    tensors on the device already).

    ``merge=True`` (float32 tables) returns ``(wind_co, wind_dual)`` with the
    dual-pol merge done: each piece's winds go through the ``dual_merge``
    kernel (:func:`~xsarsea_tpu_torch.ops.inversion_kernels.dual_merge`, its
    plain version on the CPU), which packs and merges them in one pass.
    """
    device = torch.device(device)
    mode = _resolve_mode(mode, tables, device)
    dtype = tables.dtype
    if isinstance(source, _LazySource) and source.device_db is None:
        # auto: linear sigma0 to the device on the f32 fused path (a per-call
        # copy, so the caller's source keeps its own setting)
        source = copy.copy(source)
        source.device_db = mode in _FUSED_MODES and dtype == torch.float32
    fn = _get_invert_fn(tables, chunk_size, mode, device)
    # filled on the device: a host-to-device copy would wait for it
    dsig_t = torch.full((), float(dsig_co), dtype=dtype, device=device)
    n = source.n
    bounds = _pieces(n, piece_size or (1 << 22))
    count("pieces", len(bounds))
    # with the inputs on the device and the results staying there, a piece has
    # no copy to hide: the lanes would only add their threads' hand-overs
    resident = device_output and isinstance(source, _PreparedSource) and source.resident(device)
    overlap = _overlap and len(bounds) > 1 and not resident
    lanes = _Lanes(device, overlap)

    def compute(prepared):
        with span("xs.compute"):
            lanes.join(*prepared)
            co_re, co_im, du_re, du_im = fn(*prepared[0], dsig_t)
            if merge:
                return K.dual_merge(co_re, co_im, du_re, du_im)
            return torch.complex(co_re, co_im), torch.complex(du_re, du_im)

    parts = []
    faulted = None
    if not device_output:
        ctype = np.complex128 if dtype == torch.float64 else np.complex64
        wind_co = np.empty(n, dtype=ctype)
        wind_dual = np.empty(n, dtype=ctype)
        if device.type == "cuda" and not overlap:
            # the outputs' pages fault in on a worker while the host prepares
            # and the card computes, so that the drain on this thread only
            # copies (the overlapped loop drains on a worker already)
            faulted = staging.prefault(wind_co, wind_dual)

    def drain(copies, lo, hi):
        with span("xs.drain"):
            if faulted is not None:
                faulted.result()
            copies[0].into(wind_co[lo:hi])
            copies[1].into(wind_dual[lo:hi])

    if not overlap:
        for lo, hi in bounds:
            winds = compute(lanes.prepare(source, lo, hi, dtype))
            if device_output:
                parts.append(winds)
            else:
                drain([staging.HostCopy(w) for w in winds], lo, hi)
    else:
        with ThreadPoolExecutor(max_workers=1) as prep_worker, \
                ThreadPoolExecutor(max_workers=1) as drain_worker:
            ahead = prep_worker.submit(lanes.prepare, source, *bounds[0], dtype)
            drains = []
            for i, (lo, hi) in enumerate(bounds):
                with span("xs.wait.prep"):
                    prepared = ahead.result()
                if i + 1 < len(bounds):
                    ahead = prep_worker.submit(lanes.prepare, source, *bounds[i + 1], dtype)
                if len(drains) >= 2:
                    with span("xs.wait.drain"):
                        drains[-2].result()  # at most two pieces' results in flight
                winds = compute(prepared)
                if device_output:
                    parts.append(winds)
                else:
                    copies = [staging.HostCopy(w, lanes.copy_out) for w in winds]
                    drains.append(drain_worker.submit(drain, copies, lo, hi))
            with span("xs.wait.drain"):
                for d in drains:
                    d.result()

    if device_output:
        with span("xs.cat"):
            co, dual = (torch.cat(p) for p in zip(*parts))
        return co, dual
    return wind_co, wind_dual


def invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, ancillary_wind, dsig_co=0.1,
                  chunk_size=256, mode="auto", device="cuda", device_output=False,
                  piece_size=None):
    """Invert flat pixel arrays (numpy or tensors, sigma0 in dB) against
    prepared tables. ``ancillary_wind`` is complex (antenna convention).

    Returns (wind_co, wind_dual) complex numpy arrays, or complex tensors on
    ``device`` with ``device_output=True``. ``chunk_size`` is the exact
    path's pixels per batch. See the module docstring for ``mode``.
    """
    with call("invert_pixels", device, int(inc.shape[0])):
        source = _PreparedSource(inc, s0_co_db, s0_cr_db, dsig_cr, ancillary_wind)
        return _invert_source(tables, source, dsig_co=dsig_co, chunk_size=chunk_size,
                              mode=mode, device=device, device_output=device_output,
                              piece_size=piece_size)


# ------------------------------------------------------------- public facade

def _raw_data(x):
    """Underlying data of a DimArray or array-like; Python and numpy scalars
    become 0-d arrays so the piece slicer can use them."""
    if x is None:
        return None
    data = x.data if isinstance(x, DimArray) else x
    if isinstance(data, torch.Tensor):
        return data
    if not hasattr(data, "ndim") or (data.ndim == 0 and not isinstance(data, np.ndarray)):
        data = np.asarray(data)
    return data


def _any_valid(x):
    """True when ``x`` holds at least one non-NaN value (row blocks with
    early exit for host and chunked arrays, so a lazy scene is never read
    whole; a device reduction for tensors)."""
    if x is None:
        return False
    data = _raw_data(x)
    if isinstance(data, torch.Tensor):
        return bool(torch.any(~torch.isnan(data)))
    if not is_chunked(data):
        data = np.asarray(data)
    if data.ndim == 0:
        return bool(~np.isnan(data))
    rest = int(np.prod(data.shape[1:], dtype=np.int64))
    step = max(1, (1 << 22) // max(1, rest))
    return any(np.any(~np.isnan(np.asarray(data[r0:r0 + step])))
               for r0 in range(0, data.shape[0], step))


@xarray_io
@timing(logger=logger.info)
def invert_from_model(inc, sigma0, sigma0_dual=None, /, ancillary_wind=None, dsig_co=0.1,
                      dsig_cr=0.1, model=None, dtype=None, mode="auto", piece_size=None,
                      device_db=None, device="cuda", nesz_cr=None, **kwargs):
    """Invert sigma0 (linear) into wind speed and direction with GMF/LUT models.

    Mono-pol (copol or crosspol) with one model, or dual-pol with
    ``model=(model_co, model_cr)`` (reference windspeed.py:17-128). Returns
    complex wind (modulus m/s, angle = direction in antenna convention), a
    DimArray when an input is one, the caller's DataArray class when an
    input is DataArray-like. Dual-pol returns ``(wind_co, wind_dual)``
    where wind_dual takes copol where either speed is < 5 m/s
    (windspeed.py:425-428): on a CUDA device with float32 tables the card
    merges each piece before its copy out (the ``dual_merge`` kernel; a
    speed decides by its float32 modulus rounded once from float64), else
    numpy merges on the host (``np.abs``).

    ``dsig_cr``: the crosspol cost's weight, a scalar or an array
    broadcastable to the scene; or the name of a ``get_dsig`` scheme (e.g.
    ``"gmf_s1_v2"``) with ``nesz_cr``, the crosspol channel's raw linear NESZ
    of the scene's (line, sample) shape: the call then runs xsarsea's L1
    example in one, ``nesz_flattening(nesz_cr, inc)`` and ``get_dsig(dsig_cr,
    inc, sigma0_cr, nesz_flat)`` on the device, the rows fitted once a scene
    in float64 and each piece weighted as it is prepared; the flattened NESZ
    and the weights never come back to the host. ``inc`` is then the scene
    array or an ``(nx,)`` sample vector.

    ``device``: where the inversion runs (default ``"cuda"``). ``dtype``:
    the tables' precision; default float32 on CUDA, float64 elsewhere.
    ``inc`` may be the scene array or broadcastable to it (see
    ``_LazySource``); ``device_db`` chooses where linear sigma0 becomes dB
    (default: on the device in the float32 fused mode, on the host in f64
    otherwise). ``**kwargs`` go to ``Model.to_lut`` (LUT resolution).
    """
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    with call("invert_from_model", device) as this:
        with span("xs.validate"):
            models, shape, raw_inc, raw_s0_co, raw_s0_cr = _check_inputs(
                inc, sigma0, sigma0_dual, ancillary_wind, model)
        this.pixels = int(np.prod(shape, dtype=np.int64))
        tables = prepare_tables(models[0], models[1], dtype=dtype, **kwargs)
        scheme = isinstance(dsig_cr, str)
        source = _LazySource(shape, raw_inc, s0_co=raw_s0_co, s0_cr=raw_s0_cr,
                             dsig_cr=dsig_cr if scheme else _raw_data(dsig_cr),
                             anc=_raw_data(ancillary_wind), device_db=device_db,
                             nesz_cr=_raw_data(nesz_cr))
        if scheme:
            with span("xs.nesz"):
                source.fit_nesz(device)
        dual = sigma0_dual is not None
        # the winds are float32 on the card: merged there, piece by piece
        merge = dual and device.type == "cuda" and dtype == torch.float32
        wind_co, wind_dual = _invert_source(tables, source, dsig_co=dsig_co, mode=mode,
                                            device=device, piece_size=piece_size, merge=merge)
        if scheme:  # the card is done with the call: no wait
            count("nesz_rows_nan", source.rows_nan())
        with span("xs.merge"):
            template = next((v for v in (sigma0, inc) if isinstance(v, DimArray)), None)
            return _merge_and_wrap(wind_co.reshape(shape), wind_dual.reshape(shape), models,
                                   template, dual=dual, merged=merge)


def _check_inputs(inc, sigma0, sigma0_dual, ancillary_wind, model):
    """``invert_from_model``'s checks of its inputs: the models (copol,
    crosspol; None where absent), the scene shape and the raw incidence and
    sigma0 streams."""
    models = model if isinstance(model, tuple) else (model, None)
    models = tuple(get_model(m) if m is not None else None for m in models)
    raw_inc = _raw_data(inc)
    raw_s0 = _raw_data(sigma0)
    shape = tuple(np.shape(raw_s0))
    if sigma0_dual is not None:
        return models, shape, raw_inc, raw_s0, _raw_data(sigma0_dual)

    pol = None
    if isinstance(sigma0, DimArray):
        pol_c = sigma0.coords.get("pol")
        if pol_c is not None and np.asarray(pol_c).size == 1:
            pol = str(np.asarray(pol_c).reshape(-1)[0])
    model_pol = models[0].pol
    if pol is None:
        warnings.warn(f"Unable to check sigma0 pol. Assuming {model_pol}")
    elif pol not in model_pol:
        raise ValueError(
            f"sigma0 pol is {pol}, and model {models[0].name} can only handle {model_pol}")
    if models[0].iscopol:
        if not _any_valid(ancillary_wind):
            raise ValueError("copol inversion requires valid ancillary_wind")
        return models, shape, raw_inc, raw_s0, None
    if _any_valid(ancillary_wind):
        warnings.warn("crosspol inversion is best without ancillary wind, "
                      "but using it as requested.")
    return (None, models[0]), shape, raw_inc, None, raw_s0


def _merge_and_wrap(wind_co, wind_dual, models, template, dual, merged):
    """The dual-pol merge, in place over ``wind_dual`` unless the card
    ``merged`` it already, and each result wrapped like ``template`` (a
    DimArray, or None for plain arrays)."""
    def wrap(data, comment, model_names):
        if template is None:
            return data
        out = template.copy(data=data)
        out.attrs = {"comment": comment, "model": model_names}
        out.name = "windspeed_gmf"
        return out

    if not dual:
        if models[0] is not None:
            return wrap(wind_co, f"wind speed and direction inverted from model "
                                 f"{models[0].name} ({models[0].pol})", models[0].name)
        res = wrap(np.abs(wind_dual),
                   f"wind speed inverted from model {models[1].name} ({models[1].pol})",
                   models[1].name)
        if isinstance(res, DimArray):
            res.attrs["units"] = "m/s"
        return res

    if not merged:
        # dual-pol merge (windspeed.py:425-428): copol where either speed < 5
        # m/s, in place over wind_dual, in blocks
        co_f, du_f = wind_co.reshape(-1), wind_dual.reshape(-1)
        count("merge_px_host", co_f.shape[0])
        for lo in range(0, co_f.shape[0], 1 << 22):
            co_c, du_c = co_f[lo:lo + (1 << 22)], du_f[lo:lo + (1 << 22)]
            take_co = (np.abs(co_c) < K.MERGE_BELOW) | (np.abs(du_c) < K.MERGE_BELOW)
            du_c[take_co] = co_c[take_co]
    co_out = wrap(wind_co, f"wind speed and direction inverted from model "
                           f"{models[0].name} ({models[0].pol})", models[0].name)
    dual_out = wrap(wind_dual, f"wind speed and direction inverted from model "
                               f"{models[0].name} ({models[0].pol}) and {models[1].name} "
                               f"({models[1].pol})", f"{models[0].name} {models[1].name}")
    return co_out, dual_out
