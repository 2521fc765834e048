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
  bucketing's own for a test's duration;
* :func:`int64_bucket_by_value`, :func:`int64_bucket_by_band`,
  :func:`int64_bucket_by_band_sorted`: the bucketings as they were before
  their sorts became narrow, ``torch.sort`` of keys widened to int64 (the
  float key by :func:`int64_sort_key`'s chain) with int64 indices, assembled
  by :func:`masked_assembly`.
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
    order = order.to(torch.int64)
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


def int64_sort_key(v):
    """The unsigned 32-bit key of float32 ``v`` held as int64, by the chain
    of int64 elementwise ops the bucketing used (``_f32_sort_key_np``'s)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >> 31 == 1, (~bits) & 0xFFFFFFFF, bits | 0x80000000)
    key = torch.where(torch.isinf(v), torch.zeros_like(key), key)
    return torch.where(torch.isnan(v), torch.full_like(key, 0xFFFFFFFF), key)


def int64_bucket_by_band(band, n_bands, block, values=None):
    n = band.shape[0]
    ks, order = torch.sort(band.to(torch.int64), stable=True)
    if values is not None:
        order = values.to(torch.int64)[order]
    lb_ext = torch.searchsorted(ks, torch.arange(n_bands + 1, device=band.device))
    return masked_assembly(lb_ext, order, n, n_bands, block)


def int64_bucket_by_band_sorted(band, within, n_bands, block):
    n = band.shape[0]
    key = band.to(torch.int64) * 2 ** 32 + int64_sort_key(within.to(torch.float32))
    ks, order = torch.sort(key, stable=True)
    starts = torch.arange(n_bands + 1, device=band.device) * 2 ** 32
    return masked_assembly(torch.searchsorted(ks, starts), order, n, n_bands, block)


def int64_bucket_by_value(values_f32, boundary_keys, n_bands, block):
    n = values_f32.shape[0]
    ks, order = torch.sort(int64_sort_key(values_f32), stable=True)
    dev = values_f32.device
    lb_ext = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.searchsorted(ks, boundary_keys.to(dev).to(torch.int64) + 2 ** 31),
        torch.full((1,), n, dtype=torch.int64, device=dev),
    ])
    return masked_assembly(lb_ext, order, n, n_bands, block)


def outside_band_case(kind, n, n_bands, seed):
    """``(band, as_sentinel, n_bands, block)``: int64 bands, about a third
    of them outside ``[0, n_bands)`` (``kind`` "above": from ``n_bands`` to
    2**31 - 1, most past the key bits ``n_bands`` needs; "negative": down
    to -2**31), and the same bands with those set to the sentinel
    ``n_bands``."""
    rng = np.random.default_rng(seed)
    band = rng.integers(0, n_bands, n)
    out = rng.random(n) < 0.3
    far = {"above": [n_bands, n_bands + 1, 2 * n_bands + 3, 2 ** 20 + 5, 2 ** 31 - 1],
           "negative": [-1, -2, -n_bands, -2 ** 20 - 5, -2 ** 31]}[kind]
    band[out] = rng.choice(far, int(out.sum()))
    return band, np.where(out, n_bands, band), n_bands, 64


def bucket_route(module, route, band, n_bands, block, seed, reference=False, device="cpu"):
    """Bucket int64 ``band`` by ``route`` ("by_band", with a payload;
    "by_band_iota", without; "by_band_sorted", with a float32 key within
    each band, NaN and ties among it) through ``module``'s bucketing: the
    port's (``bucketing``) or, with ``reference``, this module's int64
    sorts."""
    rng = np.random.default_rng(seed)
    n = band.shape[0]
    prefix = "int64_" if reference else ""
    band = torch.as_tensor(band, device=device)
    if route == "by_band":
        payload = torch.as_tensor(rng.permutation(n) + 3, device=device)
        return getattr(module, prefix + "bucket_by_band")(band, n_bands, block, payload)
    if route == "by_band_iota":
        return getattr(module, prefix + "bucket_by_band")(band, n_bands, block)
    within = rng.integers(0, 50, n).astype(np.float32)
    within[::7] = np.nan
    return getattr(module, prefix + "bucket_by_band_sorted")(
        band, torch.as_tensor(within, device=device), n_bands, block)
