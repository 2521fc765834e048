"""Nearest-incidence lookup and pixel bucketing for the fused inversion.

Counterpart of ``xsarsea_tpu/ops/pallas_inversion.py:61-380``. The fused
kernels take pixels in fixed-size blocks whose pixels share one incidence
band (and, for the slab refine, one wind-speed group), so each block reads
one LUT slice. Bucketing is sort + searchsorted + one scatter on the
pixels' device: the sort is the main path's narrow radix sort
(:func:`~xsarsea_tpu_torch.ops.inversion_kernels.sort_pairs`), 32-bit keys
with a 32-bit payload over only the bits the keys hold, the rest torch ops.

The float key that the reference carries as ``uint32`` rides in ``int32``
here less 2**31 (:func:`_f32_sort_key_np`, :func:`f32_sort_key`; torch's
unsigned support is partial): torch's signed order of it is the unsigned
key's.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.inversion_kernels import GROUP_BLOCK, f32_sort_key

__all__ = [
    "DEFAULT_BLOCK",
    "band_boundaries_f32",
    "band_of_value",
    "bucket_by_band",
    "bucket_by_band_sorted",
    "bucket_by_value",
    "f32_sort_key",
    "near_uniform_fit",
    "nearest_index_near_uniform",
    "nearest_index_sorted",
    "nearest_index_uniform",
    "sorted_grid_form",
]

DEFAULT_BLOCK = GROUP_BLOCK  # pixels per stage-1 block (one incidence band each)


def _scalar(x, like):
    """``x`` as a 0-d tensor of ``like``'s dtype on its device, filled there:
    no host-to-device copy, which would wait for the device."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _first_nearest(values, cands, ks):
    """First-minimum of ``|cand - v|`` over candidate lists (strict ``<``)."""
    best_d = torch.full_like(values, float("inf"))
    best_k = torch.zeros_like(ks[0])
    for cand, k in zip(cands, ks):
        d = torch.abs(values - cand)
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_k = torch.where(better, k, best_k)
    return torch.where(torch.isnan(values), torch.zeros_like(best_k), best_k).to(torch.int32)


def nearest_index_uniform(g0, step, n, values):
    """Nearest index on a uniform grid (g0 + k*step, k<n), matching
    ``np.argmin(|grid - v|)``: candidate cell from a multiply + floor, then a
    3-candidate first-minimum compare."""
    g0 = float(g0)
    step = float(step)
    # clip to [0, n-1] so 1- and 2-point grids stay valid
    k0 = torch.clamp(torch.floor((values - g0) * _scalar(1.0 / step, values)),
                     0, n - 1).to(torch.int64)
    ks = [torch.clamp(k0 + dk, 0, n - 1) for dk in (-1, 0, 1)]
    step_t = _scalar(step, values)
    cands = [g0 + k.to(values.dtype) * step_t for k in ks]
    return _first_nearest(values, cands, ks)


def near_uniform_fit(gnp):
    """(g0, step) endpoint fit of a grid, or None if not near-uniform.

    Near-uniform: every point within 0.4*step of the fit, so the true
    nearest index is always within +-1 of the fit's candidate cell (and
    f32-cast linspace coords, whose steps jitter at ulp scale, qualify).
    """
    gnp = np.asarray(gnp, dtype=np.float64)
    n = gnp.shape[0]
    if n < 2:
        return None
    step = (gnp[-1] - gnp[0]) / (n - 1)
    if step == 0 or not np.isfinite(step):
        return None
    ideal = gnp[0] + step * np.arange(n)
    if np.max(np.abs(gnp - ideal)) >= 0.4 * abs(step):
        return None
    return float(gnp[0]), float(step)


def nearest_index_near_uniform(grid, g0, step, values):
    """Nearest index on a near-uniform grid: candidate cell from the
    (g0, step) fit, decision on the TRUE grid values of the 3 candidates
    with a strict first-minimum update (bit-matches ``np.argmin``)."""
    n = grid.shape[0]
    k0 = torch.clamp(torch.floor((values - g0) * _scalar(1.0 / step, values)),
                     0, n - 1).to(torch.int64)
    ks = [torch.clamp(k0 + dk, 0, n - 1) for dk in (-1, 0, 1)]
    return _first_nearest(values, [grid[k] for k in ks], ks)


def sorted_grid_form(grid):
    """How :func:`nearest_index_sorted` searches ``grid``: its
    :func:`near_uniform_fit` (or None) and whether it descends. Reading it
    copies a device grid to the host: a caller that looks up many value sets
    on one grid reads it once and passes it as ``form=``."""
    gnp = np.asarray(grid.detach().cpu() if torch.is_tensor(grid) else grid, np.float64)
    return near_uniform_fit(gnp), bool(gnp.shape[0] >= 2 and gnp[0] > gnp[-1])


def nearest_index_sorted(grid, values, form=None):
    """Exact nearest index on a sorted grid, matching ``np.argmin(|grid - v|)``.

    Ties resolve to the lower index (numpy's first-minimum rule). NaN and
    +-inf values give index 0 (every distance is NaN/inf: first minimum).
    Near-uniform grids take :func:`nearest_index_near_uniform`; others
    binary-search. ``grid`` is a concrete tensor on the values' device;
    ``form`` is its :func:`sorted_grid_form`, read from it when not given.
    """
    fit, descending = sorted_grid_form(grid) if form is None else form
    n = grid.shape[0]
    if fit is not None:
        return nearest_index_near_uniform(grid, fit[0], fit[1], values)
    if descending:
        # binary search on the reversed (ascending) grid; ties must still
        # resolve to the LOWER original index = higher reversed index
        rev = torch.flip(grid, (0,)).contiguous()
        i1 = torch.clamp(torch.searchsorted(rev, values.contiguous()), 1, n - 1)
        idx_rev = torch.where(values - rev[i1 - 1] < rev[i1] - values, i1 - 1, i1)
        idx = (n - 1) - idx_rev
    else:
        i1 = torch.clamp(torch.searchsorted(grid.contiguous(), values.contiguous()), 1, n - 1)
        idx = torch.where(values - grid[i1 - 1] <= grid[i1] - values, i1 - 1, i1)
    bad = torch.isnan(values) | torch.isinf(values)
    return torch.where(bad, torch.zeros_like(idx), idx).to(torch.int32)


def band_boundaries_f32(grid_np):
    """Exact f32 decision boundaries of the nearest-index rule.

    ``t[b-1]`` (b = 1..n-1) is the SMALLEST f32 value whose nearest index
    (first minimum of ``|g[k] - v|`` in f32) is ``b``, found per adjacent
    pair by bit-level binary search on the monotone predicate
    ``|g[b] - v| < |g[b-1] - v|``. Requires a strictly ascending, finite,
    non-negative f32 grid; returns None otherwise.
    """
    g = np.asarray(grid_np, np.float32)
    if g.ndim != 1 or g.shape[0] < 2 or not np.all(np.diff(g) > 0) \
            or not np.all(np.isfinite(g)) or g[0] < 0:
        return None
    out = np.empty(g.shape[0] - 1, np.float32)
    for b in range(1, g.shape[0]):
        glo, ghi = g[b - 1], g[b]

        def in_b(v):
            v = np.float32(v)
            return np.float32(np.abs(ghi - v)) < np.float32(np.abs(glo - v))

        ilo = int(glo.view(np.int32))  # predicate False here
        ihi = int(ghi.view(np.int32))  # predicate True here
        if in_b(glo) or not in_b(ghi):  # degenerate grid spacing
            return None
        while ihi - ilo > 1:  # positive f32: bit order == value order
            imid = (ilo + ihi) // 2
            if in_b(np.int64(imid).astype(np.int32).view(np.float32)):
                ihi = imid
            else:
                ilo = imid
        out[b - 1] = np.int64(ihi).astype(np.int32).view(np.float32)
    return out


def _f32_sort_key_np(v):
    """Monotone f32 -> 32-bit key (numpy, int32): the reference's unsigned
    key less 2**31, so that its signed order is the unsigned key's; the
    numpy twin of :func:`f32_sort_key`.

    Positive floats are bit-ordered; negatives flip. +-inf -> the least key
    (band 0: every |g[k] - inf| is inf, the first minimum is 0); NaN -> the
    largest (last band; NaN-guarded downstream).
    """
    v = np.asarray(v, np.float32)
    bits = v.view(np.uint32)
    key = np.where(bits >> 31 == 1, ~bits, bits | np.uint32(0x80000000))
    key = np.where(np.isinf(v), np.uint32(0), key)
    key = np.where(np.isnan(v), np.uint32(0xFFFFFFFF), key)
    return (key ^ np.uint32(0x80000000)).view(np.int32)


def _band_key(band, n_bands):
    """The int32 sort key of integer bands, and the key bits that hold it:
    a band outside ``[0, n_bands)`` becomes the sentinel ``n_bands`` (clamped
    into ``[-1, n_bands]``, where -1 wraps round to ``n_bands``)."""
    key = torch.remainder(torch.clamp(band, -1, n_bands), n_bands + 1).to(torch.int32)
    return key, max(1, int(n_bands).bit_length())


def bucket_by_band(band, n_bands, block=DEFAULT_BLOCK, values=None):
    """Group pixel indices by band into block-aligned buckets.

    Returns ``(perm, band_of_block)``: ``perm`` (int64, length
    ``(ceil(N/block) + n_bands) * block``, -1 marks padding) lists the
    ``values`` payload (default: pixel index; values fit int32) band by
    band, each band padded to a multiple of ``block``; ``band_of_block[b]``
    is block b's band. Entries with a band outside ``[0, n_bands)`` are
    sentinels: they sort past every real band and are dropped. The sort
    covers the bit length of ``n_bands``.
    """
    n = band.shape[0]
    dev = band.device
    key, bits = _band_key(band, n_bands)
    ks, order = K.sort_pairs(key, bits, None if values is None else values.to(torch.int32))
    # lb_ext[b] = first sorted slot of band b; the extra entry is the first
    # sentinel slot (= n without sentinels)
    lb_ext = torch.searchsorted(ks, torch.arange(n_bands + 1, dtype=torch.int32, device=dev))
    return _assemble_buckets(lb_ext, order, n, n_bands, block)


def bucket_by_band_sorted(band, within, n_bands, block=DEFAULT_BLOCK):
    """:func:`bucket_by_band` with each band's pixels in ascending order of
    ``within`` (float32; NaN last, equal values in pixel order): the stable
    sort of the key (band, :func:`f32_sort_key` of ``within``) as two
    stable sorts, the within key's 32 bits, then the band's bits."""
    n = band.shape[0]
    dev = band.device
    key, bits = _band_key(band, n_bands)
    _, by_within = K.sort_pairs(K.f32_sort_key(within.to(torch.float32)), 32)
    ks, order = K.sort_pairs(key[by_within], bits, by_within)
    lb_ext = torch.searchsorted(ks, torch.arange(n_bands + 1, dtype=torch.int32, device=dev))
    return _assemble_buckets(lb_ext, order, n, n_bands, block)


def band_of_value(values_f32, boundary_keys):
    """Per pixel, the band :func:`bucket_by_value` puts it in: the count of
    boundary keys at or below its value's key (NaN: the last band)."""
    return torch.searchsorted(boundary_keys.to(values_f32.device), K.f32_sort_key(values_f32),
                              right=True)


def bucket_by_value(values_f32, boundary_keys, n_bands, block=DEFAULT_BLOCK):
    """Group pixels into nearest-grid-index buckets without a per-pixel
    nearest pass: the lookup fuses into the bucket sort.

    Pixels sort by the 32-bit monotone key of their f32 value
    (:func:`f32_sort_key`); per-band segment bounds come from
    ``searchsorted`` of the precomputed boundary keys
    (:func:`band_boundaries_f32` through :func:`_f32_sort_key_np`, int32).
    Band assignment equals :func:`nearest_index_sorted` for every non-NaN
    value. NaN values sort to the LAST band (where :func:`bucket_by_band`
    over ``nearest_index_sorted`` puts them in band 0); their outputs are NaN
    either way (the postprocess guards).
    """
    n = values_f32.shape[0]
    dev = values_f32.device
    ks, order = K.sort_pairs(K.f32_sort_key(values_f32), 32)
    lb_ext = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.searchsorted(ks, boundary_keys.to(dev)),
        torch.full((1,), n, dtype=torch.int64, device=dev),
    ])
    return _assemble_buckets(lb_ext, order, n, n_bands, block)


def _assemble_buckets(lb_ext, order, n, n_bands, block):
    """Bucket assembly from per-band segment bounds and the sorted payload
    ``order`` (int32): counts -> padded offsets -> destination slots
    (telescoped sparse add + cumsum) -> one scatter.

    Every size comes from ``n``, ``n_bands`` and ``block``, and no value is
    read back: what a mask would drop goes to one spare trailing slot, cut
    off afterwards, so the host never waits for the device here."""
    dev = order.device
    lb = lb_ext[:-1]
    counts = torch.diff(lb_ext)
    pad_counts = ((counts + block - 1) // block) * block
    pad_offsets = torch.cumsum(pad_counts, 0) - pad_counts

    delta = pad_offsets - lb
    ddelta = torch.diff(delta, prepend=torch.zeros(1, dtype=delta.dtype, device=dev))
    # lb is at most n (a searchsorted over n keys); empty trailing bands
    # start at n, and their adds land in the spare slot
    sparse = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(0, lb, ddelta)
    dest = torch.arange(n, device=dev) + torch.cumsum(sparse[:n], 0)

    n_padded = ((n + block - 1) // block + n_bands) * block
    keep = torch.arange(n, device=dev) < lb_ext[-1]  # sentinels go to the spare slot
    perm = torch.full((n_padded + 1,), -1, dtype=torch.int64, device=dev)
    perm = perm.scatter_(0, torch.where(keep, dest, n_padded), order.to(torch.int64))[:n_padded]

    n_blocks = n_padded // block
    # a band's first block: below n_blocks (the padded bands fill fewer
    # blocks), clamped into the spare slot all the same
    starts = torch.clamp(pad_offsets // block, max=n_blocks)
    inc = (torch.arange(n_bands, device=dev) > 0).to(torch.int64)
    band_of_block = torch.cumsum(torch.zeros(n_blocks + 1, dtype=torch.int64, device=dev)
                                 .index_add_(0, starts, inc)[:n_blocks], 0)
    return perm, band_of_block
