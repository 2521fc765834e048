"""The bucket-ordered copies that K1-K4 do without, for the tests that hold
a launch through the bucket permutation to the same kernel on the copy.
Imports no JAX.

* :func:`slot_rows`, :func:`k2_to_pixels`, :func:`k3_to_pixels`,
  :func:`k4_to_pixels`: the fused path's copies as it made them before its
  kernels read through the bucket permutation: each slot's row gathered with
  ``where(perm >= 0, rows[perm.clamp(0)], nan)``, the results scattered back
  with boolean-mask indexing;
* :func:`copying_kernels`: K1-K4 replaced, for a test's duration, by those
  forms (copy, launch through the identity permutation, so the results come
  back in slot order, scatter back), so that the fused closure runs as it
  did with the copies;
* :func:`kernel_case`: operands of one kernel, its rows table and the bucket
  permutation of ``n_px`` pixels (a partial last block, padding slots, a NaN
  block), on any device; :func:`run_both` launches it both ways;
* :func:`masked_assembly`: the bucket assembly as it was before it became
  free of host waits, with six boolean-mask selections (each a read back of
  a mask's size); :func:`masked_bucketing` puts it in place of the
  bucketing's own for a test's duration.
"""

import numpy as np
import torch

from xsarsea_tpu_torch.ops import bucketing as B
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.bucketing import bucket_by_band

NAN = float("nan")
K1 = ("group_argmin", "group_argmin_streamed")
KERNELS = (*K1, "slab_refine_fused", "slab_refine", "crosspol_argmin")


def slot_rows(rows, perm, width=None):
    """Slot s's row of ``rows`` (its first ``width`` floats), NaN where
    ``perm[s] < 0``."""
    picked = rows[perm.clamp(min=0)] if width is None else rows[perm.clamp(min=0), :width]
    return torch.where((perm >= 0)[:, None], picked, NAN)


def identity(rows):
    """The index of rows already in slot order."""
    return torch.arange(rows.shape[0], device=rows.device)


def k2_to_pixels(vals, perm2, n):
    valid2 = perm2 >= 0
    res = torch.empty((3, n), dtype=torch.float32, device=vals.device)
    res[:, perm2[valid2]] = vals[:, valid2]
    return res


def k3_to_pixels(flat_r, perm2, n):
    valid2 = perm2 >= 0
    flat = torch.zeros(n, dtype=torch.int64, device=flat_r.device)
    flat[perm2[valid2]] = flat_r.reshape(-1)[valid2].to(torch.int64)
    return flat


def k4_to_pixels(wd, perm3, n):
    valid3 = perm3 >= 0
    out = torch.zeros(n, dtype=torch.float32, device=wd.device)
    out[perm3[valid3]] = wd.reshape(-1)[valid3]
    return out


def copied(name, fn, args, kwargs):
    """``fn`` (kernel ``name``'s wrapper) on the slot-order copy of the rows
    table that ``kwargs["index"]`` reads, through the identity permutation,
    its results scattered back."""
    kw = dict(kwargs)
    perm = kw.pop("index")
    if name in K1:
        *ops, rows, band_of_block, n_groups = args
        copy = slot_rows(rows, perm, 4)
        return fn(*ops, copy, band_of_block, n_groups, index=identity(copy), **kw)
    if name == "crosspol_argmin":
        *ops, rows, band3 = args
        copy = slot_rows(rows, perm)
        return k4_to_pixels(fn(*ops, copy, band3, index=identity(copy), **kw), perm,
                            rows.shape[0])
    *ops, rows, sband, srow0, vmask = args
    copy = slot_rows(rows, perm)
    vals = fn(*ops, copy, sband, srow0, vmask, index=identity(copy), **kw)
    to_pixels = k2_to_pixels if name == "slab_refine_fused" else k3_to_pixels
    return to_pixels(vals, perm, rows.shape[0])


def copying_kernels(monkeypatch):
    """K1-K4 in their copying forms until ``monkeypatch`` undoes it."""
    for name in KERNELS:
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _f=fn, **kw: copied(_n, _f, a, kw))


def same_bits(a, b):
    """Equal bit for bit, NaN payloads included; integers equal in value
    (K3's index comes back int32 from the kernel, int64 from the scatter)."""
    if not (a.is_floating_point() or a.is_complex()):
        return a.shape == b.shape and torch.equal(a.long().cpu(), b.long().cpu())
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if a.dtype in (torch.float32, torch.float64):
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _lut_operands(rng, n_inc=6, n_wspd=120, n_phi=181, n_cr=90):
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    lut[1, 40, 10] = np.nan
    wspd = np.linspace(0.2, 50, n_wspd).astype(np.float32)
    phir = np.deg2rad(np.linspace(0, 180, n_phi)).astype(np.float32)
    u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np.float32)
    crlut = rng.uniform(-40, -20, (n_inc, n_cr)).astype(np.float32)
    crw = np.linspace(3, 80, n_cr).astype(np.float32)
    return lut, wspd, phir, u, v, crlut, crw


def kernel_case(name, n_px, device, seed=0):
    """``(args, kwargs)`` of kernel ``name`` on a table of ``n_px`` pixels
    bucketed by a random key, ``kwargs["index"]`` the bucket permutation.
    K1 and K2 read an 8-float rows table (K1 its first 4 floats), K3 and K4
    a 4-float one; a block of pixels has NaN s0 (a coast); K1's staged form
    takes a 4 x 4-strided coarse grid, its streamed form the full grid."""
    rng = np.random.default_rng(seed)
    n_inc = 6
    lut, wspd, phir, u, v, crlut, crw = _lut_operands(rng, n_inc=n_inc)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if name == "crosspol_argmin":
        has_co = (rng.random(n_px) < 0.8).astype(np.float32)
        rows = np.stack([rng.uniform(-38, -22, n_px), rng.uniform(0.1, 1.0, n_px),
                         has_co * rng.uniform(0, 20, n_px), has_co], 1).astype(np.float32)
    else:
        rows = np.stack([rng.uniform(-30, -5, n_px), rng.uniform(-12, 12, n_px),
                         rng.uniform(0, 12, n_px), np.full(n_px, 10.0),
                         rng.uniform(-38, -22, n_px), rng.uniform(0.1, 1.0, n_px),
                         np.zeros(n_px), np.zeros(n_px)], 1).astype(np.float32)
        if name == "slab_refine":
            rows = np.ascontiguousarray(rows[:, :4])
    coast = slice(n_px // 3, n_px // 3 + max(1, n_px // 10))
    rows[coast, 0] = np.nan
    rows = dev(rows)

    if name in K1:
        stride = 4 if name == "group_argmin" else 1
        lut_c, u_c, v_c, row_group, n_groups = K.build_coarse_arrays(lut, u, v, stride, stride)
        perm, band_of_block = bucket_by_band(dev(rng.integers(0, n_inc, n_px)), n_inc,
                                             K.GROUP_BLOCK)
        args = (dev(lut_c), dev(u_c), dev(v_c), dev(row_group, torch.int32), rows,
                band_of_block, n_groups)
        kw = {"index": perm}
        if name == "group_argmin_streamed":
            kw["radii"] = dev(K.build_chunk_radii(u_c, v_c))
        return args, kw
    if name == "crosspol_argmin":
        perm3, band3 = bucket_by_band(dev(rng.integers(0, n_inc, n_px)), n_inc, K.CR_BLOCK)
        return (*(dev(a) for a in K.build_crosspol_arrays(crlut, crw)), rows, band3), \
            {"block": K.CR_BLOCK, "index": perm3}
    lut_pad, u_pad, v_pad = (dev(a) for a in K.build_direct_arrays(lut, u, v))
    wp = lut_pad.shape[1]
    n_groups = -(-wspd.shape[0] // K.WGROUP)
    perm2, key_of_block = bucket_by_band(dev(rng.integers(0, n_inc * n_groups, n_px)),
                                         n_inc * n_groups, K.SLAB_BLOCK)
    sband = torch.div(key_of_block, n_groups, rounding_mode="floor")
    srow0 = torch.clamp((key_of_block % n_groups) * K.WGROUP - K.SLAB_MARGIN, 0,
                        wp - K.SLAB_ROWS)
    vmask = (perm2 >= 0).reshape(-1, K.SLAB_BLOCK).any(dim=1)
    tail = (sband, srow0, vmask)
    if name == "slab_refine":
        return (lut_pad, u_pad, v_pad, rows, *tail), {"block": K.SLAB_BLOCK, "index": perm2}
    return (lut_pad, u_pad, v_pad, dev(K.build_decode_arrays(wspd, wp)), dev(phir),
            *(dev(a) for a in K.build_crosspol_arrays(crlut, crw)), rows, *tail), \
        {"has_cr": True, "block": K.SLAB_BLOCK, "index": perm2}


def run_both(name, args, kwargs):
    """Kernel ``name`` through the index, and on the copy made beforehand."""
    fn = getattr(K, name)
    return fn(*args, **kwargs), copied(name, fn, args, kwargs)


def masked_assembly(lb_ext, order, n, n_bands, block):
    """``bucketing._assemble_buckets`` as it was with boolean masks: the
    entries a mask drops (empty trailing bands' starts, sentinels, block
    starts past the last block) are selected out instead of sent to a spare
    slot."""
    dev = order.device
    lb = lb_ext[:-1]
    counts = torch.diff(lb_ext)
    pad_counts = ((counts + block - 1) // block) * block
    pad_offsets = torch.cumsum(pad_counts, 0) - pad_counts

    delta = pad_offsets - lb
    ddelta = torch.diff(delta, prepend=torch.zeros(1, dtype=delta.dtype, device=dev))
    inside = lb < n
    sparse = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, lb[inside], ddelta[inside])
    dest = torch.arange(n, device=dev) + torch.cumsum(sparse, 0)

    n_padded = ((n + block - 1) // block + n_bands) * block
    keep = torch.arange(n, device=dev) < lb_ext[-1]
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


def masked_bucketing(monkeypatch):
    """The bucketing assembles with :func:`masked_assembly` until
    ``monkeypatch`` undoes it."""
    monkeypatch.setattr(B, "_assemble_buckets", masked_assembly)
