"""Nearest-incidence lookup and pixel bucketing for the fused inversion.

Counterpart of ``xsarsea_tpu/ops/pallas_inversion.py:61-380``. The fused
kernels take pixels in fixed-size blocks whose pixels share one incidence
band (and, for the slab refine, one wind-speed group), so each block reads
one LUT slice. Bucketing is sort + searchsorted + one scatter, as torch ops
on the pixels' device.

Keys that the reference carries as ``uint32`` ride in ``int64`` here
(torch's unsigned support is partial); the order is the same.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DEFAULT_BLOCK",
    "band_boundaries_f32",
    "bucket_by_band",
    "bucket_by_value",
    "f32_sort_key",
    "near_uniform_fit",
    "nearest_index_near_uniform",
    "nearest_index_sorted",
    "nearest_index_uniform",
]

DEFAULT_BLOCK = 256  # pixels per stage-1 block (one incidence band each)


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
    k0 = torch.clamp(torch.floor((values - g0) * torch.tensor(1.0 / step, dtype=values.dtype,
                                                              device=values.device)),
                     0, n - 1).to(torch.int64)
    ks = [torch.clamp(k0 + dk, 0, n - 1) for dk in (-1, 0, 1)]
    step_t = torch.tensor(step, dtype=values.dtype, device=values.device)
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
    k0 = torch.clamp(torch.floor((values - g0) * torch.tensor(1.0 / step, dtype=values.dtype,
                                                              device=values.device)),
                     0, n - 1).to(torch.int64)
    ks = [torch.clamp(k0 + dk, 0, n - 1) for dk in (-1, 0, 1)]
    return _first_nearest(values, [grid[k] for k in ks], ks)


def nearest_index_sorted(grid, values):
    """Exact nearest index on a sorted grid, matching ``np.argmin(|grid - v|)``.

    Ties resolve to the lower index (numpy's first-minimum rule). NaN and
    +-inf values give index 0 (every distance is NaN/inf: first minimum).
    Near-uniform grids take :func:`nearest_index_near_uniform`; others
    binary-search. ``grid`` is a concrete tensor on the values' device.
    """
    gnp = grid.detach().cpu().numpy().astype(np.float64)
    n = grid.shape[0]
    fit = near_uniform_fit(gnp)
    if fit is not None:
        return nearest_index_near_uniform(grid, fit[0], fit[1], values)
    if n >= 2 and gnp[0] > gnp[-1]:
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
    """Monotone f32 -> unsigned 32-bit key (numpy; returned as int64).

    Positive floats are bit-ordered; negatives flip. +-inf -> 0 (band 0:
    every |g[k] - inf| is inf, the first minimum is 0); NaN -> max key
    (last band; NaN-guarded downstream).
    """
    v = np.asarray(v, np.float32)
    bits = v.view(np.uint32)
    key = np.where(bits >> 31 == 1, ~bits, bits | np.uint32(0x80000000))
    key = np.where(np.isinf(v), np.uint32(0), key)
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), key).astype(np.int64)


def f32_sort_key(v):
    """Tensor twin of :func:`_f32_sort_key_np` (f32 in, int64 keys out)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >> 31 == 1, (~bits) & 0xFFFFFFFF, bits | 0x80000000)
    key = torch.where(torch.isinf(v), torch.zeros_like(key), key)
    return torch.where(torch.isnan(v), torch.full_like(key, 0xFFFFFFFF), key)


def bucket_by_band(band, n_bands, block=DEFAULT_BLOCK, values=None):
    """Group pixel indices by band into block-aligned buckets.

    Returns ``(perm, band_of_block)``: ``perm`` (int64, length
    ``(ceil(N/block) + n_bands) * block``, -1 marks padding) lists the
    ``values`` payload (default: pixel index) band by band, each band padded
    to a multiple of ``block``; ``band_of_block[b]`` is block b's band.
    Entries with ``band >= n_bands`` are sentinels: they sort past every
    real band and are dropped.
    """
    n = band.shape[0]
    ks, order = torch.sort(band.to(torch.int64), stable=True)
    if values is not None:
        order = values.to(torch.int64)[order]
    # lb_ext[b] = first sorted slot of band b; the extra entry is the first
    # sentinel slot (= n without sentinels)
    lb_ext = torch.searchsorted(ks, torch.arange(n_bands + 1, device=band.device))
    return _assemble_buckets(lb_ext, order, n, n_bands, block)


def bucket_by_value(values_f32, boundary_keys, n_bands, block=DEFAULT_BLOCK):
    """Group pixels into nearest-grid-index buckets without a per-pixel
    nearest pass: the lookup fuses into the bucket sort.

    Pixels sort by the monotone key of their f32 value; per-band segment
    bounds come from ``searchsorted`` of the precomputed boundary keys
    (:func:`band_boundaries_f32` through the same key transform). Band
    assignment equals :func:`nearest_index_sorted` for every non-NaN value.
    NaN values sort to the LAST band (where :func:`bucket_by_band` over
    ``nearest_index_sorted`` puts them in band 0); their outputs are NaN
    either way (the postprocess guards).
    """
    n = values_f32.shape[0]
    ks, order = torch.sort(f32_sort_key(values_f32), stable=True)
    dev = values_f32.device
    lb_ext = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.searchsorted(ks, boundary_keys.to(dev)),
        torch.full((1,), n, dtype=torch.int64, device=dev),
    ])
    return _assemble_buckets(lb_ext, order, n, n_bands, block)


def _assemble_buckets(lb_ext, order, n, n_bands, block):
    """Bucket assembly from per-band segment bounds: counts -> padded
    offsets -> destination slots (telescoped sparse add + cumsum) -> one
    scatter."""
    dev = order.device
    lb = lb_ext[:-1]
    counts = torch.diff(lb_ext)
    pad_counts = ((counts + block - 1) // block) * block
    pad_offsets = torch.cumsum(pad_counts, 0) - pad_counts

    delta = pad_offsets - lb
    ddelta = torch.diff(delta, prepend=torch.zeros(1, dtype=delta.dtype, device=dev))
    inside = lb < n  # empty trailing bands start at n: dropped
    sparse = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, lb[inside], ddelta[inside])
    dest = torch.arange(n, device=dev) + torch.cumsum(sparse, 0)

    n_padded = ((n + block - 1) // block + n_bands) * block
    keep = torch.arange(n, device=dev) < lb_ext[-1]  # sentinels are never placed
    perm = torch.full((n_padded,), -1, dtype=torch.int64, device=dev)
    perm[dest[keep]] = order[keep]

    n_blocks = n_padded // block
    starts = pad_offsets // block
    inc = torch.ones(n_bands, dtype=torch.int64, device=dev)
    inc[0] = 0
    in_range = starts < n_blocks
    band_of_block = torch.cumsum(torch.zeros(n_blocks, dtype=torch.int64, device=dev)
                                 .index_add_(0, starts[in_range], inc[in_range]), 0)
    return perm, band_of_block
