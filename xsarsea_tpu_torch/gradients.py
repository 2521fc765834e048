"""Wind-streak direction analysis (Koch 2004): counterpart of
``xsarsea_tpu.gradients``.

Re-design of the reference gradients pipeline (after W. Koch, "Directional
analysis of SAR images aiming at wind direction", IEEE TGRS 42(4), 2004):

* the OpenCV Scharr stencils, B-spline smoothers and the anti-moiré R2
  pyramid are shifted-slice stencils (:mod:`xsarsea_tpu_torch.ops.conv2d`);
* cv2 INTER_AREA multiscale resampling is two fractional-area weight matmuls;
* the per-window direction histograms (72 bins over [-pi/2, pi/2], weights
  ``r*c`` with the data-dependent median of |G2|) are computed for ALL
  windows at once: one index gather extracts the windows, one sort gives the
  medians and one ``index_add_`` bins the weights — replacing the
  reference's ``xr.rolling(...).construct`` + ``apply_ufunc(vectorize=True)``
  python loop (gradients.py:102-116, 151-160, 828-879).

Containers are :class:`~xsarsea_tpu_torch.dimarray.DimArray` /
:class:`~xsarsea_tpu_torch.dimarray.DimDataset`. Every entry point takes
``device`` under the package's rule: a tensor payload is computed where it
lives, a numpy (or chunked) one on ``device`` (default ``"cuda"``, which
raises on a host without a card). Results carry tensors on the compute
device; ``DimArray.values`` brings them to the host.

On a CUDA device the histogram's ``index_add_`` is atomic adds: the order of
the sum is unspecified, so two runs can differ in the last bits. Card and CPU
agree to a tolerance, never bit for bit.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray, DimDataset, blocked_coord_mean, is_chunked
from xsarsea_tpu_torch.interop import is_dataarray_like, to_dataset, to_dimarray
from xsarsea_tpu_torch.ops.conv2d import (
    B2_KERNEL,
    B4_KERNEL,
    conv2d_same,
    local_mean,
    r2_reduce,
    resize_area,
    scharr,
    smooth_b2,
    zoom_bilinear,
)
from xsarsea_tpu_torch.utils import as_tensor, compute_device, to_host

logger = logging.getLogger("xsarsea_tpu_torch.gradients")

__all__ = [
    "Gradients",
    "Gradients2D",
    "StackedGradients",
    "local_gradients",
    "streaks_histogram_core",
    "convolve2d",
    "gradient_histogram",
    "circ_smooth",
    "circ_hist",
    "filtering_parameters",
    "R2",
    "Mean",
    "smoothing",
]


def _as_da(x, dims=("line", "sample")):
    if is_dataarray_like(x):
        x = to_dimarray(x)
    if isinstance(x, DimArray):
        missing = {d: np.arange(x.sizes[d]) for d in x.dims if d not in x.coords}
        return x.assign_coords(**missing) if missing else x
    x = np.asarray(x) if not hasattr(x, "dtype") else x
    return DimArray(x, dims=dims,
                    coords={d: np.arange(s) for d, s in zip(dims, x.shape)})


def _coord_step(coord):
    """Reference spacing estimator: np.unique(np.diff(ax))[0]."""
    return float(np.unique(np.diff(np.asarray(coord, dtype=np.float64)))[0])


def _on_device(da, device):
    """A DimArray's payload as a tensor on the call's device."""
    return as_tensor(da.data, compute_device(device, da.data))


def _scalar(value, like):
    """``value`` as a 0-d tensor beside ``like``: a divide by it is a true
    divide on every device (by a Python scalar, CUDA multiplies by the
    reciprocal, an ulp off)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------ basic filters

def R2(image, device="cuda"):
    """Reduce by 2 without moiré (B4 pre-smooth, trim-mean, B2 post-smooth).

    DimArray coords are block-averaged like xarray's coarsen
    (gradients.py:689-721).
    """
    da = _as_da(image)
    x = conv2d_same(_on_device(da, device), B4_KERNEL, boundary="symm")
    tmp = da.copy(data=x).coarsen_mean({"line": 2, "sample": 2})
    out = conv2d_same(tmp.data, B2_KERNEL, boundary="symm")
    return tmp.copy(data=out)


def convolve2d(in1, in2, boundary="symm", fillvalue=0.0, device="cuda"):
    """scipy.signal.convolve2d(mode='same') on a DimArray/array image.

    API-parity wrapper for the reference helper (gradients.py:637-672); the
    stencil runs on the device, with no map_overlap machinery.
    """
    da = _as_da(in1)
    kernel = to_host(in2) if isinstance(in2, torch.Tensor) else np.asarray(in2)
    return da.copy(data=conv2d_same(_on_device(da, device), kernel, boundary=boundary,
                                    fillvalue=fillvalue))


def gradient_histogram(g2, c, angles_bins, device="cuda"):
    """Weighted direction histogram of ONE window (gradients.py:828-879).

    ``g2``: complex local gradients (2-D window), ``c``: quality weights,
    ``angles_bins``: bin centers. Returns (histogram, used_ratio) as a numpy
    array and a float: a single-window wrapper over the batched routine the
    pipeline uses.
    """
    device = compute_device(device, g2, c)
    g2 = to_host(g2) if isinstance(g2, torch.Tensor) else np.asarray(g2)
    c = to_host(c) if isinstance(c, torch.Tensor) else np.asarray(c, dtype=float)
    hist, ratio = _histogram_windows(
        as_tensor(np.abs(g2).reshape(1, -1), device),
        as_tensor(np.angle(g2).reshape(1, -1), device),
        as_tensor(np.asarray(c, dtype=float).reshape(1, -1), device),
        as_tensor(np.asarray(angles_bins, dtype=float), device),
    )
    return to_host(hist[0]), float(ratio[0])


def smoothing(image, device="cuda"):
    """B2 smoothing (gradients.py:675-686)."""
    da = _as_da(image)
    return da.copy(data=smooth_b2(_on_device(da, device)))


def Mean(image, device="cuda"):
    """Local mean operator (B4 then B42 smoothing, gradients.py:724-755)."""
    da = _as_da(image)
    return da.copy(data=local_mean(_on_device(da, device)))


def _lg_arrays(ampl):
    """Local-gradients core on tensors (see local_gradients).

    ``ampl`` is the amplitude image (already R2-reduced + sqrt'ed by the
    caller), or a stack of them. Returns ``(re2, im2, g3, g2_abs, g2_angle,
    c)`` on the 2x-reduced grid. The squared gradient is carried as a real
    pair through the R2 cascades; its principal-branch sqrt is |z|^0.5 and
    angle(z)/2.
    """
    grad_r = scharr(ampl, axis=1)
    grad_i = scharr(ampl, axis=0)
    # (grad_r + i*grad_i)^2 as a real pair
    re12 = grad_r * grad_r - grad_i * grad_i
    im12 = 2.0 * grad_r * grad_i
    abs12 = torch.hypot(re12, im12)

    re2 = r2_reduce(re12)
    im2 = r2_reduce(im12)
    g3 = r2_reduce(abs12)
    abs2 = torch.hypot(re2, im2)
    c = abs2 / (g3 + 0.00001)
    c = torch.where(c <= 1.0, c, torch.zeros_like(c))
    return re2, im2, g3, torch.sqrt(abs2), torch.atan2(im2, re2) / 2.0, c


def _streaks_lg(img):
    """sigma0 -> (G2_abs, G2_angle, c) on the 4x-reduced grid; ``img`` is a
    tensor, one image or a stack of them."""
    ampl = torch.sqrt(r2_reduce(img))
    _, _, _, g2_abs, g2_angle, c = _lg_arrays(ampl)
    return g2_abs, g2_angle, c


def _streaks_lg_batched(*imgs):
    """``_streaks_lg`` over images of one shape as one stacked call: the
    multiscale Gradients fan-out runs the conv cascade once per resolution
    level instead of once per (pol, window_size) combo."""
    return _streaks_lg(torch.stack(imgs))


def _multiscale_hist_fused(base, centers_l, centers_s, angles_bins, factors, spec):
    """The whole multiscale fan-out over one sigma0 stack.

    ``base``: (npol, H, W) sigma0 tensor; ``factors``: tuple of downscale
    factors (one resolution level each); ``spec``: tuple of (level_index,
    window_px) per (factor x window_size) combo; ``centers_l``/``centers_s``:
    per-combo window-center indices on that combo's lg grid (all combos share
    the window-center *coordinates*, so every combo yields the same (nl, ns)
    output grid).

    INTER_AREA resampling and the R2/Scharr local-gradients cascade run once
    per level on all pols at once; then every window+histogram stage. Returns
    (weight (npol, ndf, nws, nl, ns, n_angles) normalized by window pixels,
    used_ratio (npol, ndf, nws, nl, ns)).
    """
    lgs = []
    for f in factors:
        img = base if f == 1 else resize_area(base, (base.shape[1] // f, base.shape[2] // f))
        lgs.append(_streaks_lg(img))

    hists, ratios = [], []
    for (lvl, win), cl, cs in zip(spec, centers_l, centers_s):
        per_pol = [_windows_hist_fused(a, b, q, cl, cs, win, angles_bins)
                   for a, b, q in zip(*lgs[lvl])]
        h = torch.stack([p[0] for p in per_pol])
        r = torch.stack([p[1] for p in per_pol])
        nl, ns = len(cl), len(cs)
        hists.append(h.reshape(h.shape[0], nl, ns, -1) / _scalar(win * win, h))
        ratios.append(torch.nan_to_num(r.reshape(r.shape[0], nl, ns)))
    w = torch.stack(hists, dim=1)
    r = torch.stack(ratios, dim=1)
    ndf, nws = len(factors), len(spec) // len(factors)
    return (w.reshape((w.shape[0], ndf, nws) + w.shape[2:]),
            r.reshape((r.shape[0], ndf, nws) + r.shape[2:]))


def _r2_coord(c):
    """Coordinate of one R2 reduction (the shared coarsen rule, so the
    injected _lg_hist coords are bit-identical to the fallback path's)."""
    return blocked_coord_mean(c, 2)


def _window_grid(coords, window_size, window_step):
    """Window-center grid {line, sample} from full-resolution coords.

    SINGLE source of the stepping rule (mean window size in px ->
    stride = ws_px * window_step, >= 1 px): Gradients2D.windows_at and
    the fused multiscale fan-out must agree bit-for-bit on it.
    """
    ws_px = int(np.mean([
        window_size / _coord_step(coords[d]) for d in ("line", "sample")
    ]))
    step = int(ws_px * window_step)
    if step < 1:
        raise ValueError(
            f"window_step={window_step} with ~{ws_px}px windows "
            f"gives a stride of {step} px; window_step must be "
            f">= 1/window_size_px (stride >= 1 pixel)")
    return {"line": np.asarray(coords["line"][::step]),
            "sample": np.asarray(coords["sample"][::step])}


def _lg_window_spec(coords, window_size, at):
    """(win_px, cl, cs) on the lg grid of full-resolution ``coords``.

    The lg grid is two R2 coarsenings (pure coordinate arithmetic, no
    data); ``win_px`` is the window size in lg pixels and cl/cs the
    nearest-lg-pixel index per requested center. SINGLE source of the
    snapping rule shared by the per-instance and fused paths (their
    equivalence test depends on it).
    """
    lg = {d: _r2_coord(_r2_coord(coords[d])) for d in ("line", "sample")}
    win = int(np.mean([
        window_size / _coord_step(lg[d]) for d in ("line", "sample")
    ]))
    cl = np.abs(
        lg["line"][None, :] - np.asarray(at["line"])[:, None]
    ).argmin(axis=1).astype(np.int32)
    cs = np.abs(
        lg["sample"][None, :] - np.asarray(at["sample"])[:, None]
    ).argmin(axis=1).astype(np.int32)
    return win, cl, cs


def _angle_bin_centers(n_angles):
    """Centers of the n_angles bins over [-pi/2, pi/2] (one rule for
    both histogram paths)."""
    bins = np.linspace(-np.pi / 2, np.pi / 2, n_angles + 1)
    return (bins[1:] + bins[:-1]) / 2


def local_gradients(image, device="cuda"):
    """Local squared gradients with quality index (gradients.py:588-634).

    Returns a DimDataset with variables:

    * ``G2_abs``/``G2_angle`` — modulus and angle of the complex local
      gradient (sqrt of the R2-reduced squared Scharr gradient; angles
      in (-pi/2, pi/2], 180°-ambiguous);
    * ``G2`` — the complex gradient itself (complex64 or complex128);
    * ``G3`` — R2 of |G²| (gradient energy);
    * ``c``  — quality index |R2(G²)| / G3, clipped to [0, 1].
    """
    da = _as_da(image)
    re2, im2, g3, g2_abs, g2_angle, c = _lg_arrays(_on_device(da, device))

    coords = {k: v for k, v in da.coords.items()
              if k not in ("line", "sample")}
    for d in ("line", "sample"):
        if d in da.coords:
            coords[d] = _r2_coord(da.coords[d])

    def mk(data, name):
        return DimArray(data, dims=da.dims, coords=coords, attrs=da.attrs,
                        name=name)

    return DimDataset({
        "G2_abs": mk(g2_abs, "G2_abs"),
        "G2_angle": mk(g2_angle, "G2_angle"),
        "G3": mk(g3, "G3"),
        "c": mk(c, "c"),
        "G2": mk(torch.sqrt(torch.complex(re2, im2)), "G2"),
    })


# ------------------------------------------------ windowed histogram routine

def _histogram_windows(abs_win, ang_win, c_win, angles_bins, total=None):
    """Direction histograms for a batch of windows.

    abs_win/ang_win: (nwin, wpix) modulus and angle of the complex local
    gradient; c_win: (nwin, wpix) real; angles_bins: (n_angles,) bin
    centers; all tensors on one device. Returns (hist (nwin, n_angles),
    used_ratio (nwin,)). Faithful to gradient_histogram
    (gradients.py:828-879): weights ``r*c`` with r = |g2|/(|g2|+median|g2|)
    over the window's valid pixels; bin k = round((angle-start)/step), half
    to even.

    ``total``: the true window pixel count for the used_ratio
    denominator — pass window**2 when the windows came from
    _extract_windows' clipped slabs (wpix < window**2 at grid edges).

    The bins are summed by one ``index_add_`` on the flat index
    ``window * n_angles + k``: on a CUDA device in an unspecified order.
    """
    n_angles = angles_bins.shape[0]
    nwin, wpix = abs_win.shape
    if total is None:
        total = wpix

    abs_g2 = abs_win
    mask1 = (~torch.isnan(abs_g2)) & (abs_g2 > 0)

    # masked median of |g2| per window
    vals = torch.where(mask1, abs_g2, _scalar(float("inf"), abs_g2))
    svals = torch.sort(vals, dim=1).values
    n = mask1.sum(dim=1)
    lo_i = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    hi_i = torch.div(n, 2, rounding_mode="floor").clamp(min=0)
    lo = torch.gather(svals, 1, lo_i[:, None])[:, 0]
    hi = torch.gather(svals, 1, hi_i[:, None])[:, 0]
    med = torch.where(n > 0, (lo + hi) / 2.0, _scalar(float("nan"), abs_g2))

    angles_bins = angles_bins.to(ang_win.dtype)
    step = angles_bins[1] - angles_bins[0]
    start = angles_bins[0]
    k = torch.round((ang_win - start) / step)

    r = abs_g2 / (abs_g2 + med[:, None])
    w = r * c_win
    mask2 = mask1 & (~torch.isnan(k)) & (~torch.isnan(w))
    wm = torch.where(mask2, w, torch.zeros_like(w))
    # k is NaN where the angle is, and a NaN -> integer cast is undefined:
    # select 0 there first (wm is 0 there anyway). The reference would crash
    # on the k == n_angles edge (angle exactly +pi/2): clip into the last bin
    ki = torch.where(mask2, k, torch.zeros_like(k)).clamp(0, n_angles - 1).to(torch.int64)

    flat_idx = (torch.arange(nwin, device=wm.device)[:, None] * n_angles + ki).reshape(-1)
    hist = torch.zeros(nwin * n_angles, dtype=wm.dtype, device=wm.device)
    hist.index_add_(0, flat_idx, wm.reshape(-1))
    ratio = n.to(abs_g2.dtype) / _scalar(total, abs_g2)
    return hist.reshape(nwin, n_angles), ratio


def _extract_windows(arr, centers_l, centers_s, pad_before, window):
    """Gather centered windows, clipped to the grid, NaN outside it.

    Window anchoring matches xarray rolling(center=True).construct
    (xarray Variable.rolling_window pads start = window // 2 — its
    source comment reads "10 -> 5, 9 -> 4" — and pandas rolling agrees,
    verified: a centered w=4 window at label i covers [i-2, i+1]):
    start index = center - window//2, covering
    [c - w//2, c + w-1 - w//2]. For odd windows this equals the
    (w-1)//2 anchor.

    Each window is a CLIPPED ``(min(w, n_l), min(w, n_s))`` slab at a
    clamped start (it always covers the window∩grid intersection), with
    in-slab-but-outside-the-window elements masked to NaN — exactly the
    values a NaN-pad-then-slice form produces on the intersection,
    without gathering or (median-)sorting the padding. The default
    multiscale config has windows larger than the lg grid (window_size
    3200 -> 800 lg px on a 512 grid). ``pad_before`` is kept for signature
    stability (unused). Downstream per-window reductions must normalize by
    the true window area (w*w), not the slab width — see _histogram_windows'
    ``total`` argument.

    ``arr``: a (n_l, n_s) tensor, or (C, n_l, n_s) with a leading channel
    axis; all channels share one gather of flat positions ``row * n_s +
    col`` (``nwin * pix`` int64 indices, ``nwin * C * pix`` elements read).
    The result is (nwin, pix), or (nwin, C, pix) as a view whose channel
    planes ``[:, k, :]`` are contiguous.
    """
    del pad_before
    batched = arr.ndim == 3  # optional leading channel axis (C, n_l, n_s)
    if not batched:
        arr = arr[None]
    nch, n_l, n_s = arr.shape
    sz_l, sz_s = min(window, n_l), min(window, n_s)
    dev = arr.device

    def axis(centers, n, sz):
        """Clamped slab positions (ncenters, sz) and their in-window mask."""
        lo = torch.as_tensor(centers, device=dev).to(torch.int64) - window // 2  # may be < 0
        st = lo.clamp(0, n - sz)
        pos = st[:, None] + torch.arange(sz, device=dev)
        return pos, (pos >= lo[:, None]) & (pos < lo[:, None] + window)

    rows, row_ok = axis(centers_l, n_l, sz_l)
    cols, col_ok = axis(centers_s, n_s, sz_s)
    ncl, ncs = rows.shape[0], cols.shape[0]
    flat = (rows[:, None, :, None] * n_s + cols[None, :, None, :]).reshape(ncl * ncs, -1)
    ok = (row_ok[:, None, :, None] & col_ok[None, :, None, :]).reshape(ncl * ncs, -1)
    nan = complex("nan+nanj") if arr.is_complex() else float("nan")
    wins = arr.reshape(nch, -1)[:, flat]  # (C, nwin, pix)
    wins = torch.where(ok, wins, torch.full((), nan, dtype=arr.dtype, device=dev))
    return wins.permute(1, 0, 2) if batched else wins[0]


#: stencil contamination radius of the input->local-gradients chain, in
#: INPUT rows: lg row q reads input rows [4q-14, 4q+17] (B4+coarsen+B2 ->
#: i2 radius 5, Scharr +-1, second R2 -> i2 [2q-5, 2q+6]); 24 covers it
#: with slack and keeps 4-row alignment.
_LG_MARGIN_IN = 24


def _banded_streaks_hist(img, centers_l, centers_s, window, angles_bins,
                         max_block_px=1 << 25, device="cuda"):
    """Out-of-core windowed streaks histograms over row bands.

    ``img`` is any 2-D array with numpy-style first-axis slicing (dask,
    zarr, h5py, memmap, numpy): only the input rows feeding one band of
    window centers — window extent plus the ``_LG_MARGIN_IN`` stencil
    halo — are materialized at a time, one request ``img[in_lo:in_hi]`` a
    band, and each band runs through the same core as the in-memory path.
    Band input ranges are extended (upward first) with REAL image rows to
    one common height, so no padding can disturb the boundary handling: a
    block edge coincides with the image edge exactly where the whole-image
    computation's symm/NaN boundary applies. Row-band starts are 4-aligned,
    so each block's lg grid is an exact row-shifted slice of the full
    image's: results equal the whole-image computation's when it fits one
    band, and agree to the order of the histogram's sum across bands.

    Each band goes to the device through pinned staging without blocking and
    its histograms stay there until the last band is enqueued, so reading
    band k+1 from the source overlaps the device's work on band k.

    This is the counterpart of the reference's dask ``map_overlap``
    execution of the gradients stencils (gradients.py:649-667). Returns
    (hist (ncl*ncs, n_angles), ratio (ncl*ncs,)) as tensors on the device.
    """
    device = compute_device(device)
    ny, nx = (int(s) for s in img.shape)
    cl = np.asarray(centers_l, dtype=np.int64)
    cs = torch.as_tensor(np.asarray(centers_s, dtype=np.int64), device=device)
    ncs = cs.shape[0]
    win2 = window // 2  # leftmost row a window reaches (xarray anchor)

    order = None
    if np.any(np.diff(cl) < 0):  # user-set windows_at may be unsorted
        order = np.argsort(cl, kind="stable")
        cl = cl[order]

    # greedy grouping of (ascending) center rows into bands bounded by
    # the block budget
    max_rows = max(4 * window + 2 * _LG_MARGIN_IN + 8,
                   (max_block_px // max(1, nx)) // 4 * 4)
    bands = []
    start = 0
    for i in range(1, len(cl) + 1):
        if i == len(cl) or (
                4 * (cl[i] - cl[start] + window) + 2 * _LG_MARGIN_IN
                > max_rows):
            bands.append((start, i))
            start = i

    def span(b0, b1):
        lg_lo = int(cl[b0]) - win2
        lg_hi = int(cl[b1 - 1]) - win2 + window
        in_lo = max(0, 4 * lg_lo - _LG_MARGIN_IN) // 4 * 4
        in_hi = min(ny, 4 * lg_hi + _LG_MARGIN_IN)
        return in_lo, in_hi

    # common block height of REAL rows: every band's range is extended
    # (upward first) to exactly H, so every band asks its source for the same
    # number of rows and no padding can disturb the boundary handling
    H = min(ny, max(hi - lo for lo, hi in (span(*b) for b in bands)))

    bins_d = torch.as_tensor(np.asarray(angles_bins), device=device)

    hists, ratios = [], []
    for b0, b1 in bands:
        in_lo0, in_hi0 = span(b0, b1)
        # extend (upward first) to height H with a 4-aligned start; a
        # band whose span reaches the bottom edge re-anchors there so the
        # block ends EXACTLY at ny (the symm boundary must reflect at the
        # true edge — when ny % 4 != 0 this gives one extra block shape
        # of height H..H+3). Interior spans may lose up to 3 margin rows
        # to the alignment floor; the 24-row halo absorbs that (>= 18
        # needed).
        in_lo = max(0, min(in_lo0, in_hi0 - H)) // 4 * 4
        in_hi = min(ny, in_lo + H)
        if in_hi0 == ny and in_hi < ny:
            in_lo = max(0, ny - H) // 4 * 4
            in_hi = ny
        block = as_tensor(np.asarray(img[in_lo:in_hi]), device)
        # centers relative to the block's lg grid (in_lo is 4-aligned, so
        # the block's coarsen pairs align with the full image's)
        cl_band = torch.as_tensor(cl[b0:b1] - in_lo // 4, device=device)
        h, r = streaks_histogram_core(block, cl_band, cs, window, bins_d)
        hists.append(h.reshape(b1 - b0, ncs, -1))
        ratios.append(r.reshape(b1 - b0, ncs))
    hist = torch.cat(hists)
    ratio = torch.cat(ratios)
    if order is not None:
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        inv = torch.as_tensor(inv, device=device)
        hist, ratio = hist[inv], ratio[inv]
    return hist.reshape(len(cl) * ncs, -1), ratio.reshape(len(cl) * ncs)


def _windows_hist_fused(g2_abs, g2_angle, c, centers_l, centers_s, window,
                        angles_bins):
    """Window extraction + histogram. The three channels ride ONE stacked
    gather (see _extract_windows' channel axis) instead of three separate
    extraction passes."""
    w3 = _extract_windows(torch.stack([g2_abs, g2_angle, c]),
                          centers_l, centers_s, window, window)
    return _histogram_windows(w3[:, 0, :], w3[:, 1, :], w3[:, 2, :],
                              angles_bins, total=window * window)


def streaks_histogram_core(img, centers_l, centers_s, window, angles_bins, device="cuda"):
    """The streaks pipeline on arrays: local gradients → centered windows →
    direction histograms, with nothing that waits for the device.

    ``img``: (line, sample) linear sigma0; ``centers_l``/``centers_s``:
    integer window-center indices in local-gradient pixels; ``window``:
    window size in lg pixels; ``angles_bins``: bin centers. Returns tensors
    (weight (nwin, n_angles) normalized by window pixels, used_ratio
    (nwin,)) — the reference histogram contract (gradients.py:89-125).
    """
    img = as_tensor(img, compute_device(device, img))
    bins = as_tensor(angles_bins, img.device)
    g2_abs, g2_angle, c = _streaks_lg(img)
    hist, ratio = _windows_hist_fused(g2_abs, g2_angle, c, centers_l,
                                      centers_s, window, bins)
    return hist / _scalar(window * window, hist), torch.nan_to_num(ratio)


# --------------------------------------------------------------- Gradients2D

class Gradients2D:
    """Single-pol, single-scale gradients analysis (gradients.py:45-205).

    Parameters mirror the reference: ``window_size`` is expressed in the
    coordinate units of ``sigma0`` (so it is resolution-independent),
    ``window_step`` the sliding overlap (1 = non-overlapping), or
    ``windows_at`` an explicit dict of window-center coordinates.
    ``device``: where the analysis runs (a tensor sigma0 is analysed where it
    lives).
    """

    def __init__(self, sigma0, window_size=1600, window_step=None, windows_at=None,
                 device="cuda"):
        if window_step is not None and windows_at is not None:
            raise ValueError("window_step and windows_at are mutually exclusive")
        if window_step is None and windows_at is None:
            window_step = 1
        self._da_cls = type(sigma0) if is_dataarray_like(sigma0) else None
        self.sigma0 = _as_da(sigma0)
        self.device = compute_device(device, self.sigma0.data)
        self.window_size = window_size
        self.window_step = window_step
        self._windows_at = windows_at
        self.n_angles = 72
        self._lg_v = None
        self._lg_hist_v = None
        # bumped on every (re)assignment of _lg/_lg_hist — the histogram
        # cache keys on it (an id()-based key could serve a stale result
        # if a replaced object's id were recycled)
        self._lg_gen = 0
        # last (windows_at fingerprint) -> histogram DimDataset, so
        # repeated .histogram reads don't re-run the device pipeline
        self._hist_cache = None

    @property
    def _lg(self):
        return self._lg_v

    @_lg.setter
    def _lg(self, value):
        self._lg_v = value
        self._lg_gen += 1

    @property
    def _lg_hist(self):
        """(G2_abs, G2_angle, c) DimArrays injected by the multiscale
        Gradients fan-out — computed ONCE per (pol, downscale factor)
        in a pol-batched call and shared across window sizes."""
        return self._lg_hist_v

    @_lg_hist.setter
    def _lg_hist(self, value):
        self._lg_hist_v = value
        self._lg_gen += 1

    @property
    def i2(self):
        """sigma0 reduced by 2, no moiré."""
        return R2(self.sigma0, device=self.device)

    @property
    def ampl(self):
        i2 = self.i2
        return i2.copy(data=torch.sqrt(i2.data))

    @property
    def local_gradients(self):
        if self._lg is None:
            self._lg = local_gradients(self.ampl, device=self.device)
        return self._lg

    @property
    def windows_at(self):
        """Window center coordinates dict {'line': ..., 'sample': ...}."""
        if self._windows_at is None and self.window_step is not None:
            self._windows_at = _window_grid(
                self.sigma0.coords, self.window_size, self.window_step)
        return self._windows_at

    @windows_at.setter
    def windows_at(self, value):
        self._windows_at = value

    @property
    def histogram(self):
        """Per-window direction histogram (weight, used_ratio).

        Equivalent of the reference histogram property (gradients.py:89-125)
        including the extra-bin suppression and window-pixel normalization.
        Returns a DimDataset — or an xr.Dataset when sigma0 came in as an
        xr.DataArray (reference parity: gradients.py:120-125).
        """
        ds = self._histogram_native
        if self._da_cls is not None:
            xr_ds = to_dataset(ds.variables, self._da_cls)
            if xr_ds is not None:
                return xr_ds
        return ds

    @property
    def _histogram_native(self):
        at = self.windows_at
        # window size in lg pixels + nearest lg pixel per requested
        # center: pure coordinate arithmetic (two R2 coarsenings), so
        # out-of-core inputs stay unmaterialized; _lg_window_spec is the
        # single source shared with the fused fan-out
        win, cl, cs = _lg_window_spec(self.sigma0.coords, self.window_size,
                                      at)
        # generation of the lg sources: injecting _lg_hist (multiscale)
        # or computing .local_gradients after a cached call must
        # invalidate (a counter, not id()s — ids can be recycled)
        cache_key = (win, self._lg_gen, self.n_angles,
                     np.asarray(at["line"]).tobytes(),
                     np.asarray(at["sample"]).tobytes())
        if self._hist_cache is not None and self._hist_cache[0] == cache_key:
            return self._hist_cache[1]
        angles_bins = _angle_bin_centers(self.n_angles)

        raw = self.sigma0.data
        if self._lg_hist is not None or self._lg is not None:
            # lg already available: injected by the multiscale fan-out
            # (once per pol x factor), or cached from a prior
            # .local_gradients access — don't re-run the conv cascade
            if self._lg_hist is not None:
                g2, g2_ang, c = self._lg_hist
            else:
                lg = self._lg
                g2, g2_ang, c = lg["G2_abs"], lg["G2_angle"], lg["c"]
            hist, ratio = _windows_hist_fused(
                *(as_tensor(v.data, self.device) for v in (g2, g2_ang, c)),
                cl, cs, win, as_tensor(angles_bins, self.device))
            hist = hist / _scalar(win * win, hist)
        elif is_chunked(raw):
            # out-of-core: stream row bands through the core (which
            # already normalizes by window pixels)
            hist, ratio = _banded_streaks_hist(raw, cl, cs, win, angles_bins,
                                               device=self.device)
        else:
            # standalone in-memory: the same core, which also keeps the
            # banded path equal to it in its single-band case
            hist, ratio = streaks_histogram_core(raw, cl, cs, win, angles_bins,
                                                 device=self.device)

        nl, ns = len(cl), len(cs)
        coords = {"line": np.asarray(at["line"]), "sample": np.asarray(at["sample"]),
                  "angles": angles_bins}
        # carry non-dim coords (pol / downscale_factor / window_size scalars)
        for k, v in self.sigma0.coords.items():
            if k not in ("line", "sample"):
                coords[k] = v
        weight = DimArray(
            hist.reshape(nl, ns, self.n_angles),
            dims=("line", "sample", "angles"), coords=coords, name="weight",
        )
        used = DimArray(
            torch.nan_to_num(ratio.reshape(nl, ns)),
            dims=("line", "sample"), coords=coords, name="used_ratio",
        )
        ds = DimDataset({"weight": weight, "used_ratio": used})
        self._hist_cache = (cache_key, ds)
        return ds


class StackedGradients:
    """Stack several Gradients2D along a 'stacked' dim (gradients.py:208-245).

    All windows are aligned onto the first instance's centers; other
    histograms are linearly interpolated onto them.
    """

    def __init__(self, gradients):
        self._ref = gradients[0]
        self._others = gradients[1:]
        for g in self._others:
            g.windows_at = self._ref.windows_at

    @property
    def histogram(self):
        ref_hist = self._ref._histogram_native
        line = ref_hist["weight"].coords["line"]
        sample = ref_hist["weight"].coords["sample"]
        aligned = [
            g._histogram_native.interp(line=line, sample=sample)
            for g in self._others
        ]
        return DimDataset.concat([ref_hist] + aligned, dim="stacked")


class _LazyPolSlice:
    """2-D lazy row-sliceable view of one pol of a 3-D chunked array.

    Presents the first-axis-slicing protocol (shape/ndim/dtype/chunks +
    ``view[r0:r1]``) over rows of ONE pol of a (pol, line, sample)
    chunked source, so the banded out-of-core streaks path can stream a
    multi-pol scene pol by pol without ever materializing a full pol
    plane (the reference fans out dask-backed 3-D sigma0 lazily,
    gradients.py:279-300). Needs basic 2-axis slicing on the source —
    dask, zarr, h5py and np.memmap all provide it.
    """

    def __init__(self, src, ip):
        self._src = src
        self._ip = int(ip)
        self.shape = tuple(int(s) for s in src.shape[1:])
        self.ndim = 2
        self.dtype = np.dtype(src.dtype)
        ch = getattr(src, "chunks", None)
        self.chunks = (tuple(ch[1:]) if ch is not None and len(ch) == 3
                       else ((self.shape[0],), (self.shape[1],)))

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return np.asarray(self._src[(self._ip,) + idx])


class Gradients:
    """Multiscale, multi-resolution weighted direction histograms.

    Mirrors the reference fan-out (gradients.py:248-334): for every
    pol x downscale_factor, sigma0 is INTER_AREA-resampled and analyzed at
    every window size; all histograms are aligned on the first instance's
    window grid. ``.histogram`` has dims (pol, downscale_factor,
    window_size, line, sample, angles). ``device``: where the analysis runs
    (a tensor sigma0 is analysed where it lives).
    """

    def __init__(self, sigma0, windows_sizes=[1600], downscales_factors=[1],
                 window_step=1, device="cuda"):
        self._da_cls = type(sigma0) if is_dataarray_like(sigma0) else None
        # always through _as_da: it fills missing dim coords with arange
        # (a DimArray without line/sample coords must work too)
        sigma0 = _as_da(sigma0, dims=("pol", "line", "sample")
                        if getattr(sigma0, "ndim", 2) == 3 else ("line", "sample"))
        self.device = compute_device(device, sigma0.data)
        self._drop_pol = "pol" not in sigma0.dims
        pol_slices = None
        if self._drop_pol and is_chunked(sigma0.data):
            # never np.expand_dims a lazy array (it would materialize the
            # whole scene): treat it as one virtual pol slice — the
            # banded per-instance path keeps it out-of-core
            pol_slices = [sigma0.assign_coords(pol=np.asarray("pol0"))]
            pols = np.array(["pol0"])
        elif self._drop_pol:
            sigma0 = sigma0.expand_dims("pol")
            if "pol" not in sigma0.coords:
                sigma0 = sigma0.assign_coords(pol=np.array(["pol0"]))
        if pol_slices is None:
            pols = np.asarray(sigma0.coords.get(
                "pol", np.arange(sigma0.sizes["pol"])))
            if is_chunked(sigma0.data):
                # multi-pol chunked scene: virtual 2-D lazy views per pol
                # stream through the banded per-pol path (the source must
                # support basic 2-axis slicing — dask/zarr/h5py/memmap do)
                spatial = {k: v for k, v in sigma0.coords.items()
                           if k != "pol"}
                # _LazyPolSlice needs basic 2-axis slicing; the package
                # lazy protocol only guarantees FIRST-axis slicing, so
                # probe one tiny access up front and fail with a clear
                # message instead of an opaque error deep in the banded
                # streaming path
                try:
                    probe = np.asarray(sigma0.data[(0, slice(0, 1))])
                    if probe.ndim != 2:
                        raise TypeError(
                            f"probe returned ndim={probe.ndim}, need 2")
                except Exception as e:  # noqa: BLE001 — capability probe
                    raise NotImplementedError(
                        "multi-pol chunked Gradients input needs a 3-D "
                        "lazy array supporting src[pol, row0:row1] "
                        "slicing (dask/zarr/h5py/np.memmap do); this "
                        f"source does not ({type(e).__name__}: {e}). "
                        "Slice pols yourself and pass per-pol 2-D "
                        "chunked arrays instead.") from e
                pol_slices = [
                    DimArray(_LazyPolSlice(sigma0.data, ip),
                             dims=("line", "sample"),
                             coords=dict(spatial, pol=pols[ip]),
                             attrs=sigma0.attrs)
                    for ip in range(sigma0.sizes["pol"])]
            else:
                pol_slices = [sigma0.isel(pol=ip)
                              for ip in range(sigma0.sizes["pol"])]
        self.sigma0 = sigma0
        self.windows_sizes = list(windows_sizes)
        self.downscales_factors = list(downscales_factors)
        # None -> 1, the same normalization Gradients2D applies at init:
        # the fused and per-instance paths must agree on the window grid
        self._window_step = 1 if window_step is None else window_step
        self.n_angles = 72  # angular bins; propagated to every instance
        self._pols = pols
        self._pol_slices = pol_slices
        self._chunked = any(is_chunked(s.data) for s in pol_slices)
        if self._chunked and any(df != 1 for df in downscales_factors):
            raise NotImplementedError(
                "downscales_factors != 1 needs the scene in memory "
                "(INTER_AREA resampling); out-of-core (chunked) input "
                "supports downscales_factors=[1] only")
        self._combos = [(p, df, ws) for p in pols
                        for df in self.downscales_factors
                        for ws in self.windows_sizes]
        # per-instance machinery (gradients_list / stacked_gradients) is
        # built on first access: the fused histogram path never needs the
        # per-combo resampled arrays
        self._instances = None
        self._lg_groups = None
        self._lg_ready = False
        self._fused_cache = None

    @property
    def gradients_list(self):
        """Per-(pol, factor, window_size) Gradients2D instances
        (reference gradients.py:251-300). Built lazily; mutating an
        instance (e.g. its windows_at) routes .histogram through the
        per-instance path so the mutation is honored."""
        self._build_instances()
        return self._instances

    @property
    def stacked_gradients(self):
        self._build_instances()
        return self._stacked

    def _build_instances(self):
        if self._instances is not None:
            return
        self._instances = []
        self._lg_groups = []  # one (s0, [Gradients2D...]) per (pol, factor)
        for ip in range(len(self._pols)):
            for df in self.downscales_factors:
                s0 = Gradients._sigma0_resample(self._pol_slices[ip], df, self.device)
                group = []
                for ws in self.windows_sizes:
                    g2d = Gradients2D(s0, window_size=ws, device=self.device)
                    g2d.n_angles = self.n_angles
                    self._instances.append(g2d)
                    group.append(g2d)
                self._lg_groups.append((s0, group))
        self._instances[0].window_step = self._window_step
        self._stacked = StackedGradients(self._instances)

    # ---------------------------------------------------------- fused path

    def _level_coords(self, df):
        """line/sample coords of one resolution level (host arithmetic
        only — identical to _sigma0_resample's coordinate rule)."""
        ref = self._pol_slices[0]
        if df == 1:
            return {d: np.asarray(ref.coords[d]) for d in ("line", "sample")}
        return {d: blocked_coord_mean(ref.coords[d], df)
                for d in ("line", "sample")}

    def _windows_at_shared(self):
        """The shared window-center coordinates: first combo's grid
        (same rule as Gradients2D.windows_at, which StackedGradients
        propagates to every instance)."""
        c0 = self._level_coords(self.downscales_factors[0])
        return _window_grid(c0, self.windows_sizes[0], self._window_step)

    def _histogram_fused(self):
        """All (pol x factor x window_size) histograms over one stack."""
        at = self._windows_at_shared()
        wl = np.asarray(at["line"])
        wsamp = np.asarray(at["sample"])
        # key covers EVERY public attribute the fused path reads —
        # including windows_sizes / downscales_factors, which only shape
        # the per-combo spec loop below, not the shared window grid
        key = (wl.tobytes(), wsamp.tobytes(), self.n_angles,
               tuple(self.windows_sizes), tuple(self.downscales_factors))
        if self._fused_cache is not None and self._fused_cache[0] == key:
            return self._fused_cache[1]

        bins = _angle_bin_centers(self.n_angles)

        spec, centers_l, centers_s = [], [], []
        for li, df in enumerate(self.downscales_factors):
            lc = self._level_coords(df)
            for wsz in self.windows_sizes:
                # _lg_window_spec is the SINGLE source of the lg-grid
                # snapping rule — the per-instance Gradients2D path uses
                # the same helper, which is what the fused-vs-instances
                # equivalence test relies on
                win, cl, cs = _lg_window_spec(lc, wsz, at)
                spec.append((li, win))
                centers_l.append(cl)
                centers_s.append(cs)

        base = as_tensor(self.sigma0.data, self.device)
        weight, ratio = _multiscale_hist_fused(
            base, tuple(centers_l), tuple(centers_s), as_tensor(bins, self.device),
            tuple(self.downscales_factors), tuple(spec))

        coords = {"pol": self._pols,
                  "downscale_factor": np.asarray(self.downscales_factors),
                  "window_size": np.asarray(self.windows_sizes),
                  "line": wl, "sample": wsamp, "angles": bins}
        dims = ("pol", "downscale_factor", "window_size", "line", "sample")
        ds = DimDataset({
            "weight": DimArray(weight, dims=dims + ("angles",),
                               coords=coords, name="weight"),
            "used_ratio": DimArray(ratio, dims=dims, coords=coords,
                                   name="used_ratio"),
        })
        self._fused_cache = (key, ds)
        return ds

    def _precompute_lg(self):
        """Batch the local-gradients fan-out.

        The conv pipeline (R2 -> Scharr -> R2 cascade) is by far the
        expensive part of a multiscale run; the naive fan-out re-runs it
        once per (pol x factor x window_size). Here it runs once per
        *resolution level*: images of equal shape (all pols of one
        downscale factor) are stacked and pushed through one call, and every
        window size shares the result.
        """
        if self._lg_ready:
            return
        self._build_instances()

        by_shape = defaultdict(list)
        for s0, group in self._lg_groups:
            if is_chunked(s0.data):
                # out-of-core inputs take the banded per-instance path
                # (factor-1 only: resampling needs the data in memory)
                continue
            by_shape[tuple(s0.shape)].append((s0, group))
        for entries in by_shape.values():
            abs_b, ang_b, c_b = _streaks_lg_batched(
                *(as_tensor(s0.data, self.device) for s0, _ in entries))
            for k, (s0, group) in enumerate(entries):
                coords = {kk: vv for kk, vv in s0.coords.items()
                          if kk not in ("line", "sample")}
                coords["line"] = _r2_coord(_r2_coord(s0.coords["line"]))
                coords["sample"] = _r2_coord(_r2_coord(s0.coords["sample"]))
                trio = tuple(
                    DimArray(arr[k], dims=("line", "sample"), coords=coords,
                             name=nm)
                    for arr, nm in ((abs_b, "G2_abs"), (ang_b, "G2_angle"),
                                    (c_b, "c")))
                for g2d in group:
                    g2d._lg_hist = trio
        self._lg_ready = True

    @property
    def histogram(self):
        if not self._chunked and self._instances is None:
            # fast path: the entire fan-out over one stack (the
            # per-instance path below is semantically identical; it remains
            # authoritative whenever a user has touched .gradients_list —
            # instance mutations like a reassigned windows_at must be honored)
            ds = self._histogram_fused()
        else:
            self._precompute_lg()
            stacked = self.stacked_gradients.histogram
            npol = len(np.unique([c[0] for c in self._combos]))
            ndf = len(self.downscales_factors)
            nws = len(self.windows_sizes)

            out = {}
            for name, var in stacked.variables.items():
                data = var.data.reshape((npol, ndf, nws) + var.shape[1:])
                coords = {k: v for k, v in var.coords.items()}
                coords["pol"] = np.asarray(
                    self.sigma0.coords.get("pol", np.arange(npol)))
                coords["downscale_factor"] = np.asarray(
                    self.downscales_factors)
                coords["window_size"] = np.asarray(self.windows_sizes)
                dims = ("pol", "downscale_factor", "window_size") + var.dims[1:]
                out[name] = DimArray(data, dims=dims, coords=coords,
                                     name=name)
            ds = DimDataset(out)
        if self._drop_pol:
            ds = ds.isel(pol=0)
        if self._da_cls is not None:
            xr_ds = to_dataset(ds.variables, self._da_cls)
            if xr_ds is not None:
                return xr_ds
        return ds

    @staticmethod
    def _sigma0_resample(sigma0, factor, device="cuda"):
        """INTER_AREA downscale by integer factor with averaged coords
        (gradients.py:336-362)."""
        if factor == 1:
            return sigma0
        if is_chunked(sigma0.data):
            raise NotImplementedError(
                "downscales_factors != 1 needs the scene in memory "
                "(INTER_AREA resampling); out-of-core (chunked) input "
                "supports downscales_factors=[1] only")
        target = (sigma0.sizes["line"] // factor, sigma0.sizes["sample"] // factor)
        data = resize_area(sigma0.data, target, device=device)

        coords = {k: v for k, v in sigma0.coords.items()
                  if k not in ("line", "sample")}
        coords["line"] = blocked_coord_mean(sigma0.coords["line"], factor)
        coords["sample"] = blocked_coord_mean(sigma0.coords["sample"], factor)
        out = DimArray(data, dims=("line", "sample"), coords=coords,
                       attrs=sigma0.attrs)
        return out.assign_coords(downscale_factor=np.asarray(factor))


# ------------------------------------------------------------ postprocessing

def circ_smooth(hist, device="cuda"):
    """Circular smoothing of the angle histogram with Bx..Bx8 kernels.

    Wrap-padded cascade of zero-padded 1-D convolutions along the angles
    (gradients.py:882-923), each a sum of shifted slices.
    """
    Bx = np.array([1, 2, 1], float) / 4
    Bx2 = np.array([1, 0, 2, 0, 1], float) / 4
    Bx4 = np.array([1, 0, 0, 0, 2, 0, 0, 0, 1], float) / 4
    Bx8 = np.array([1, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 1], float) / 4
    Bs = [Bx, Bx2, Bx4, Bx8]
    pad = max(len(B) for B in Bs)

    da = hist if isinstance(hist, DimArray) else _as_da(hist, dims=("angles",))
    ax = da.dims.index("angles")
    data = torch.movedim(_on_device(da, device), ax, -1)
    shape = data.shape
    flat = data.reshape(-1, shape[-1])
    wrap = np.pad(np.arange(shape[-1]), (pad, pad), mode="wrap")
    flat = flat.index_select(1, torch.as_tensor(wrap, device=flat.device))

    for B in Bs:
        # true convolution: the kernel flipped, as one row of a 2-D stencil
        flat = conv2d_same(flat, B[None, :], boundary="fill")

    flat = flat[:, pad:-pad]
    out = torch.movedim(flat.reshape(shape), -1, ax)
    return da.copy(data=out)


def circ_hist(hist_at):
    """One histogram (angles mod pi) -> closed 2-pi polygon DataFrame.

    Same output contract as the reference circ_hist (gradients.py:926-958):
    a pandas.DataFrame with ['line_g', 'sample_g'] columns tracing the
    circular histogram through central symmetry. Needs pandas.
    """
    import pandas as pd

    da = hist_at if isinstance(hist_at, DimArray) else _as_da(hist_at, dims=("angles",))
    w = da.values.reshape(-1)
    ang = np.asarray(da.coords["angles"], dtype=np.float64)
    z = w * np.exp(1j * ang)
    z = np.concatenate([z, -z])
    df = pd.DataFrame({"line_g": np.imag(z), "sample_g": np.real(z)})
    return pd.concat([df, pd.DataFrame(df.iloc[[0]])])


def filtering_parameters(image_ori, device="cuda"):
    """Rain/quality mask parameters f1..f4 and F (Zhao et al. 2021).

    Faithful to the reference implementation (gradients.py:758-825):
    texture (P1), high-frequency residual (P2), gradient-energy contrast
    (P3) and gradient quality (P4), affinely mapped and clipped to [0, 1].
    """
    da = _as_da(image_ori)
    image = da.copy(data=torch.sqrt(_on_device(da, device)))

    r2 = R2(image)
    lg = local_gradients(image)
    G3, c = lg["G3"], lg["c"]
    J = Mean(r2)

    J1 = Mean(r2.copy(data=r2.data ** 2))
    J2 = torch.sqrt(J1.data - J.data ** 2)
    P1 = J2 / (J.data + 0.00001)
    a1, b1 = -50.0, 2.75

    resampl = r2.coarsen_mean({"line": 2, "sample": 2})
    up = zoom_bilinear(smoothing(resampl).data, r2.shape)
    K = r2.data - up
    P2 = K ** 2 / (J.data ** 2 + 0.00001)
    a2, b2 = -5000.0, 3.0

    G4 = Mean(G3)
    P3 = G3.data / (G4.data + 0.00001)
    a3, b3 = -2.5, 4.0

    P4 = torch.sqrt(c.data)
    a4, b4 = -10.0, 6.3

    f1 = torch.clip(a1 * P1 + b1, 0, 1)
    f2 = torch.clip(a2 * P2 + b2, 0, 1)
    f3 = torch.clip(a3 * P3 + b3, 0, 1)
    f4 = torch.clip(a4 * P4 + b4, 0, 1)
    F = torch.sqrt((f1 ** 2 + f2 ** 2 + f3 ** 2 + f4 ** 2) / 4.0)
    if F.shape == np.shape(image_ori):
        F = torch.where(F < 0.0015, torch.zeros_like(F), F)

    wrap = r2.copy
    return wrap(data=f1), wrap(data=f2), wrap(data=f3), wrap(data=f4), wrap(data=F)
