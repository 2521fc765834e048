"""The fused inversion's kernels, their plain versions and operands.

Counterpart of ``xsarsea_tpu/ops/pallas_inversion.py:382-1106``.

* K1 :func:`group_argmin` replaces ``copol_group_argmin_pallas``: per
  256-pixel block sharing one incidence band, the direct-form cost over a
  grid of LUT rows and columns, the minimum per wind-speed group
  (``WGROUP`` LUT rows) and the first-minimum group per pixel. The grid is
  the fused mode's coarse one (~0.8 m/s x 4 deg), held whole in shared
  memory; :func:`group_argmin_streamed`, its second form, takes a grid too
  large for that, the fused_exact mode's full one, streamed through shared
  memory 16 rows (a chunk) at a time, and sweeps only the chunks an exact
  lower bound on their costs cannot rule out (:func:`build_chunk_radii`,
  :func:`chunk_lower_bounds`, the plain model of its schedule
  ``_group_argmin_pruned_model``). Both deal the work to four chains a pixel
  and merge them by (minimum, group).
* K2 :func:`slab_refine_fused` replaces ``slab_refine_fused_pallas``: per
  128-pixel block sharing one (band, group), the direct-form cost over an
  ``n_rows`` x all-phi LUT slab (``SLAB_ROWS`` = 48 in the fused mode,
  ``EXACT_SLAB_ROWS`` = 32 in fused_exact) with numpy's first-minimum rule
  in (wspd-major, phi-minor) order, the decode of the winner to (wspd, phi)
  and the crosspol 1-D argmin over the band's crosspol row.
* K3 :func:`slab_refine` replaces ``slab_refine_pallas``: K2's slab sweep
  alone, emitting the winner's flat index into the (W, P) grid with the
  reference's sentinels. With K4 it serves the unfused tail, taken when the
  crosspol LUT has its own incidence axis.
* K4 :func:`crosspol_argmin` replaces ``crosspol_argmin_pallas``: per
  256-pixel block sharing one crosspol incidence band, K2's crosspol 1-D
  argmin over the band's row. On the card its quotient is hoisted (one
  reciprocal a pixel, a residual correction an entry);
  ``experiment_kernels.crosspol_quotient`` exposes that quotient so that it
  can be held against the true divide.
* :func:`dual_merge` replaces no ``pallas_call``: the dual-pol merge, which
  the JAX package runs in numpy on the host once the winds are back
  (``xsarsea_tpu/windspeed/inversion.py:1652-1659``), run on each piece's
  float32 winds before their copy out, in the pass that packs them into
  complex64.
* :func:`sort_pairs` and :func:`f32_sort_key` replace no ``pallas_call``:
  the bucketings' stable radix sort of 32-bit keys with a 32-bit payload
  over only the bits the keys hold (cub's, in the main path's library), and
  the 32-bit order-preserving key of a float32 value it sorts
  (``csrc/bucket_sort.cu``).

On a CUDA tensor each wrapper launches its hand-written kernel (the main
path's library: ``csrc/`` sources of :data:`_SOURCES`, built with nvcc for
``sm_90a`` at first use and bound with ctypes) or raises; on a CPU tensor it
runs the plain PyTorch version, which keeps the kernel's per-element op
order as separate ops. Each wrapper counts its kernel launches
(:func:`launch_counts`). The experiment kernels build into a library of
their own (:mod:`xsarsea_tpu_torch.ops.experiment_kernels`).

K1-K4 visit their pixels in bucket (slot) order and read them through the
required ``index=``, the bucket permutation (slot -> pixel, -1 for a
padding slot): the kernel reads each slot's row from ``feats``, the pixel
table, itself, NaN for padding, and K2-K4 write their results straight into
pixel order, so no copy is made on either side. A caller whose rows are
already in slot order passes the identity, ``torch.arange(n_slots)``; its
results then come back in slot order. The plain versions gather the copy,
``where(index >= 0, rows[index.clamp(0)], nan)``, compute on it and scatter
K2-K4's results back, so the two stay bit-equal. Every launch counts its
slots under ``perm_rows_read``.

The per-entry cost is ``((l - s0) * inv_dsig)^2 + (u/2 - ma/2)^2 +
(v/2 - mz/2)^2``, summed left to right, each square a plain product
(``_slab_sweep`` at pallas_inversion.py:795). The kernels use ``__f*_rn``
intrinsics and ``--fmad=false`` so no multiply-add is contracted.

What the reference's layouts did for the TPU and this port drops: the bf16
three-way split and per-band centering of the coarse operand (they served
the MXU's expanded-form matmul; the coarse pass here is direct form), the
pack-2 lane layout, 128-lane phi padding, and the one-hot MXU decode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from xsarsea_tpu_torch.utils import spans

__all__ = [
    "CHUNK_ROWS",
    "CR_BLOCK",
    "EXACT_SLAB_MARGIN",
    "EXACT_SLAB_ROWS",
    "GROUP_BLOCK",
    "KERNELS",
    "MERGE_BELOW",
    "SLAB_BLOCK",
    "SLAB_MARGIN",
    "SLAB_ROWS",
    "WGROUP",
    "build_coarse_arrays",
    "build_crosspol_arrays",
    "build_decode_arrays",
    "build_direct_arrays",
    "build_chunk_radii",
    "build_kernels",
    "check_row_group",
    "chunk_lower_bounds",
    "crosspol_argmin",
    "dual_merge",
    "f32_sort_key",
    "group_argmin",
    "group_argmin_streamed",
    "k1_staged_fits",
    "launch_counts",
    "mark_in_range",
    "reset_launch_counts",
    "slab_refine",
    "slab_refine_fused",
    "slab_smem_bytes",
    "sort_pairs",
]

GROUP_BLOCK = 256  # pixels per K1 block (one incidence band each)
WGROUP = 16  # wspd rows per group: K1's output unit, K2's bucketing unit
SLAB_MARGIN = 16  # refine window half-width in wspd rows around the group
SLAB_ROWS = WGROUP + 2 * SLAB_MARGIN  # 48 rows: [16g-16, 16g+32)
# the fused_exact mode's window around a group found on the full grid
# (xsarsea_tpu/ops/pallas_inversion.py:538)
EXACT_SLAB_MARGIN = 8
EXACT_SLAB_ROWS = WGROUP + 2 * EXACT_SLAB_MARGIN  # 32 rows: [16g-8, 16g+24)
SLAB_BLOCK = 128  # pixels per K2/K3 block (one (band, group) each)
# slab rows a shared-memory stage of the sweep holds (K2/K3's chunk_rows): 8 on
# every path, the others for scripts/bench_slab_variants.py; multiples of the
# sweep's 4 row chains
CHUNK_ROWS = (8, 16, 24, 48)
CR_BLOCK = 256  # pixels per K4 block (one crosspol band each)
_PAD_LUT = 1e19  # padded LUT rows: cost overflows to +inf, never chosen
_NAN_IDX = 2 ** 30  # K3's index for a pixel with a NaN cost in its slab
_SMEM_OPTIN = 227 * 1024  # dynamic shared memory a block may opt in to on sm_90
_PLAIN_ELEMENTS = 1 << 27  # costs a plain version materializes at once
# the dual-pol merge takes the copol wind where either speed is below this
# (m/s; reference windspeed.py:425-428)
MERGE_BELOW = 5.0

_CSRC = Path(__file__).resolve().parent / "csrc"
# the main path's library: K1-K4, the dual-pol merge and the bucketings'
# sort (the experiment kernels' sources are ops/experiment_kernels.py's)
_SOURCES = ("group_argmin.cu", "slab_refine_fused.cu", "slab_refine.cu",
            "crosspol_argmin.cu", "dual_merge.cu", "bucket_sort.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "--threads", "0")  # the sources compile side by side


def _build_dir():
    """``build/xsarsea_tpu_torch_kernels`` of the source checkout when the
    package runs from one, else ``$XDG_CACHE_HOME/xsarsea_tpu_torch/kernels``
    (``~/.cache`` by default) for an installed package."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file() and (root / "xsarsea_tpu_torch").is_dir():
        return root / "build" / "xsarsea_tpu_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "xsarsea_tpu_torch" / "kernels"


# ------------------------------------------------------------------ operands

def build_direct_arrays(lut_db, u, v):
    """Slab-refine operands: ``(lut_pad (I, Wp, P), u_half (Wp, P),
    v_half (Wp, P))`` f32.

    W is padded to ``Wp = ((W + 63) // 8 + 1) * 8`` with ``1e19`` LUT rows
    (their cost overflows to +inf), so every slab start ``clip(16g - margin,
    0, Wp - n_rows)`` (48 or 32 rows) reads real or padding rows only. u and
    v are stored halved: ``u/2 - ma/2`` rounds exactly as ``(u - ma)/2``.
    """
    lut_db = np.asarray(lut_db, dtype=np.float32)
    n_inc, n_wspd, n_phi = lut_db.shape
    wp = ((n_wspd + 63) // 8 + 1) * 8
    lut_pad = np.full((n_inc, wp, n_phi), _PAD_LUT, dtype=np.float32)
    lut_pad[:, :n_wspd] = lut_db
    u_half = np.zeros((wp, n_phi), dtype=np.float32)
    u_half[:n_wspd] = np.asarray(u, dtype=np.float32) * 0.5
    v_half = np.zeros((wp, n_phi), dtype=np.float32)
    v_half[:n_wspd] = np.asarray(v, dtype=np.float32) * 0.5
    return lut_pad, u_half, v_half


def build_coarse_arrays(lut_db, u, v, stride_w, stride_p):
    """Coarse-pass operands on rows ``arange(0, W, stride_w) ∪ {W-1}`` and
    columns ``arange(0, P, stride_p) ∪ {P-1}``.

    Returns ``(lut_c (I, R, C), u_half (R, C), v_half (R, C),
    row_group (R,) int32, n_groups)`` with ``row_group = row // WGROUP``
    and ``n_groups = ceil(W / WGROUP)``. Replaces ``_build_g4_grouped``:
    the values are the LUT's own (direct form), not an expanded-form split.
    """
    lut_db = np.asarray(lut_db, dtype=np.float32)
    n_inc, n_wspd, n_phi = lut_db.shape
    iw = np.unique(np.r_[np.arange(0, n_wspd, stride_w), n_wspd - 1])
    ip = np.unique(np.r_[np.arange(0, n_phi, stride_p), n_phi - 1])
    lut_c = np.ascontiguousarray(lut_db[:, iw][:, :, ip])
    u_half = np.ascontiguousarray(np.asarray(u, np.float32)[iw][:, ip] * 0.5)
    v_half = np.ascontiguousarray(np.asarray(v, np.float32)[iw][:, ip] * 0.5)
    row_group = (iw // WGROUP).astype(np.int32)
    return lut_c, u_half, v_half, row_group, (n_wspd + WGROUP - 1) // WGROUP


def _f32_toward(x, up):
    """float64 values rounded to float32 toward +inf (``up``) or -inf."""
    f = x.astype(np.float32)
    wrong = f.astype(np.float64) < x if up else f.astype(np.float64) > x
    return np.where(wrong, np.nextafter(f, np.float32(np.inf if up else -np.inf)), f)


def build_chunk_radii(u_half, v_half):
    """The streamed K1's annulus per chunk of ``WGROUP`` grid rows (at the
    full grid, one wind-speed group): ``(ceil(R / WGROUP), 2)`` f32 ``[r_lo,
    r_hi]``, the least and largest ``|(u/2, v/2)|`` over the cells of rows
    ``[16 c, 16 c + 16)``, computed in float64 from the float32 grids (NaN
    cells left out) and rounded outward, so that every cell's radius lies
    inside. A chunk with no cell gets ``[0, inf]``."""
    u = np.asarray(u_half, np.float32).astype(np.float64)
    v = np.asarray(v_half, np.float32).astype(np.float64)
    r = np.sqrt(u * u + v * v)  # squares exact; the sum and root err < 2**-51
    n_chunks = -(-r.shape[0] // WGROUP)
    radii = np.empty((n_chunks, 2))
    for c in range(n_chunks):
        cells = r[c * WGROUP:(c + 1) * WGROUP]
        cells = cells[~np.isnan(cells)]
        radii[c] = (cells.min(), cells.max()) if cells.size else (0.0, np.inf)
    return np.stack([_f32_toward(radii[:, 0] * (1 - 2.0 ** -50), up=False),
                     _f32_toward(radii[:, 1] * (1 + 2.0 ** -50), up=True)], 1)


def check_row_group(row_group, n_groups):
    """Raise ``ValueError`` unless ``row_group`` (R,) holds groups in
    ``[0, n_groups)`` that do not decrease along the grid's rows (K1's
    chains keep a group's rows in order).

    A tensor is read back once (a host wait). One that passes is marked, and
    the K1 wrappers do not check it again until it changes in place: the
    fused closure checks its table here once, where it builds it."""
    rg = np.asarray(row_group.detach().cpu() if torch.is_tensor(row_group) else row_group)
    if rg.size:
        mn, mx = int(rg.min()), int(rg.max())
        if mn < 0 or mx >= n_groups:
            raise ValueError(f"row_group values [{mn}, {mx}] outside [0, {n_groups})")
        if (np.diff(rg) < 0).any():
            raise ValueError("row_group must not decrease")
    if torch.is_tensor(row_group):
        row_group._k1_checked = (row_group._version, n_groups)


def _row_group_checked(row_group, n_groups):
    return getattr(row_group, "_k1_checked", None) == (row_group._version, n_groups)


def mark_in_range(index, lo, hi):
    """Mark ``index``, a tensor whose maker built it to hold values in
    ``[lo, hi)``, and return it. The wrappers' range guards then take it as
    it is, with no read back (a host wait a launch), until it changes in
    place. The maker vouches for the values: the fused closure marks the
    block bands and slab rows it builds, which lie in range by construction.
    Every unmarked index is checked."""
    index._xs_in_range = (index._version, lo, hi)
    return index


def _marked_in(index, lo, hi):
    mark = getattr(index, "_xs_in_range", None)
    return mark is not None and mark[0] == index._version and lo <= mark[1] and mark[2] <= hi


def build_decode_arrays(co_wspd, wp_rows):
    """wspd per padded LUT row, ``(Wp,)`` f32, 0 beyond the true rows."""
    w = np.asarray(co_wspd, np.float32)
    w_pad = np.zeros(wp_rows, np.float32)
    w_pad[: w.shape[0]] = w
    return w_pad


def build_crosspol_arrays(cr_lut_db, cr_wspd):
    """Crosspol operands: ``(cr_lut (I, Wc) f32, w_half (Wc,) f32)``; wspd
    is stored halved (``w/2 - wco/2`` rounds exactly as ``(w - wco)/2``)."""
    lut = np.ascontiguousarray(cr_lut_db, dtype=np.float32)
    w_half = np.asarray(cr_wspd, np.float32) * np.float32(0.5)
    return lut, w_half


# ------------------------------------------------------------ plain versions

def _sq(x):
    return x * x


def _cost(lut, u_half, v_half, s0, ma2, mz2, inv_dsig):
    """The kernels' per-entry cost, one torch op per kernel operation."""
    t1 = _sq((lut - s0) * inv_dsig)
    t2 = _sq(u_half - ma2)
    t3 = _sq(v_half - mz2)
    return (t1 + t2) + t3


def _chunk(chunk_blocks, per_block):
    """Blocks a plain version takes at once: at most ``chunk_blocks``, and
    at most ``_PLAIN_ELEMENTS`` costs (the full grid's are 23 M a block)."""
    return max(1, min(chunk_blocks, _PLAIN_ELEMENTS // max(1, per_block)))


def _slot_rows(rows, index, width):
    """The slot-order copy that the kernels never make: slot s's first
    ``width`` features from row ``index[s]`` of ``rows``, NaN where
    ``index[s] < 0`` (padding)."""
    return torch.where((index >= 0)[:, None], rows[index.clamp(min=0), :width], float("nan"))


def _to_pixels(slots, index, n_px):
    """Per-slot results ``slots`` (..., n_slots) written into pixel order
    (..., n_px) at ``index``, padding slots dropped; 0 at a pixel no slot
    names."""
    valid = index >= 0
    out = torch.zeros(slots.shape[:-1] + (n_px,), dtype=slots.dtype, device=slots.device)
    out[..., index[valid]] = slots[..., valid]
    return out


def _row_minima(lut_c, u_half, v_half, fb, band):
    """Per pixel of blocks with features ``fb`` (nb, block, 4) and LUT bands
    ``band`` (nb,), the least cost of each grid row, NaN entries left out
    (they never win): (nb, block, R)."""
    fb = fb[:, :, :, None, None]
    j = _cost(lut_c[band.to(torch.int64)][:, None], u_half, v_half, fb[:, :, 0], fb[:, :, 1],
              fb[:, :, 2], fb[:, :, 3])  # (nb, block, R, C)
    return torch.where(torch.isnan(j), float("inf"), j).amin(-1)


def _group_argmin_plain(lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                        block, chunk_blocks=16, *, index):
    n_blocks = band_of_block.shape[0]
    chunk_blocks = _chunk(chunk_blocks, block * u_half.numel())
    inf = float("inf")
    f = _slot_rows(feats, index, 4).reshape(n_blocks, block, 4)
    # blocks of NaN (padding) rows have no finite cost: their answer is known
    out = torch.full((n_blocks, block), n_groups - 1, dtype=torch.int32, device=feats.device)
    live = torch.nonzero(~torch.isnan(f).all(dim=2).all(dim=1))[:, 0]
    rg = row_group.to(torch.int64)
    for c0 in range(0, live.shape[0], chunk_blocks):
        sel = live[c0:c0 + chunk_blocks]
        rowmin = _row_minima(lut_c, u_half, v_half, f[sel], band_of_block[sel])
        gmin = torch.full(rowmin.shape[:-1] + (n_groups,), inf, dtype=rowmin.dtype,
                          device=rowmin.device)
        gmin.scatter_reduce_(-1, rg.expand_as(rowmin), rowmin, "amin")
        best = torch.argmin(gmin, -1)  # first minimum: lowest tied group
        found = torch.gather(gmin, -1, best[..., None])[..., 0] < inf
        out[sel] = torch.where(found, best, n_groups - 1).to(torch.int32)
    return out


# float32 arithmetic rounded toward -inf or +inf (the __f*_rd / __f*_ru of the
# streamed K1's bound), emulated in float64
_F32_INF = torch.tensor(float("inf"), dtype=torch.float32)


def _to_f32_toward(hi, lo, up):
    """float32 rounding of the exact value ``hi + lo`` (float64, ``lo`` the
    error term of ``hi``) toward +inf (``up``) or -inf. ``f - hi`` is exact
    (f is within a float32 ulp of hi), so the sign of ``(f - hi) - lo`` is
    that of f minus the exact value."""
    f = hi.to(torch.float32)
    d = (f.to(torch.float64) - hi) - lo
    if up:
        return torch.where(d < 0, torch.nextafter(f, _F32_INF), f)
    return torch.where(d > 0, torch.nextafter(f, -_F32_INF), f)


def _mul_toward(a, b, up):
    return _to_f32_toward(a.double() * b.double(), 0.0, up)  # float32 products are exact


def _add_toward(a, b, up):
    a, b = a.double(), b.double()
    s = a + b
    bb = s - a
    return _to_f32_toward(s, (a - (s - bb)) + (b - bb), up)  # TwoSum's error term


def _sqrt_toward(x, up):
    f = torch.sqrt(x.double()).to(torch.float32)
    sq = f.double() * f.double()  # exact
    if up:
        return torch.where(sq < x.double(), torch.nextafter(f, _F32_INF), f)
    return torch.where(sq > x.double(), torch.nextafter(f, -_F32_INF), f)


def _lower_bounds_plain(feats, radii):
    """The streamed K1's lower bound per (pixel, chunk) (``chunk_lower_bound``
    in csrc/group_argmin.cu, operation for operation)."""
    ma, mz = feats[:, 1], feats[:, 2]
    rho_lo = _sqrt_toward(_add_toward(_mul_toward(ma, ma, False), _mul_toward(mz, mz, False),
                                      False), False)[:, None]
    rho_hi = _sqrt_toward(_add_toward(_mul_toward(ma, ma, True), _mul_toward(mz, mz, True),
                                      True), True)[:, None]
    r_lo, r_hi = radii[:, 0], radii[:, 1]
    gap = torch.fmax(_add_toward(rho_lo, -r_hi, False), _add_toward(r_lo, -rho_hi, False))
    gap = torch.where(gap < 0, 0.0, gap)  # a NaN gap stays NaN
    shrink = torch.tensor(1.0 - 2.0 ** -20, dtype=torch.float32)
    tiny = torch.tensor(2.0 ** -149, dtype=torch.float32)
    return _add_toward(_mul_toward(_mul_toward(gap, gap, False), shrink, False), -tiny, False)


def _nearest_chunk(candidates, center2):
    """The candidate chunk nearest to the centre ``center2 / 2`` (the lower
    of two as near), or -1: the streamed K1's visiting order."""
    idx = torch.nonzero(candidates)[:, 0]
    if idx.numel() == 0:
        return -1
    return int(idx[torch.argmin(torch.abs(2 * idx - center2))])  # argmin: first, the lower


def _group_argmin_pruned_model(lut_c, u_half, v_half, row_group, feats, band_of_block,
                               n_groups, radii, block=GROUP_BLOCK, prune=True, chunk_blocks=16):
    """Plain model of the streamed K1's pruned schedule
    (``group_argmin_streamed_kernel`` in csrc/group_argmin.cu), block by
    block, over chunks of ``WGROUP`` grid rows. The block's home chunks are
    each live pixel's chunks of least bound; the centre is the midpoint of
    the first and last of them. The block sweeps first the home chunk
    nearest the centre, then, one at a time, the chunk nearest the centre
    among those not yet swept that a pixel needs: the next chunk is chosen
    before the current one is swept (from the need formed after the previous
    one, or the home chunks before the first), and the need is formed anew,
    from the block's merged best costs, after each chunk; when nothing was
    chosen in advance the choice is made again after the sweep. A
    (128-pixel set, row chain) sweeps a staged chunk only if a pixel of its
    set needs it by the smaller of the chain's best so far and the block's
    best when the need was last formed; chain c takes the rows r = c (mod 4)
    and keeps (minimum, ``row_group[r]``) lexicographically.
    ``prune=False``: every chunk, ascending.

    For the tests: it decides what the kernel decides, on the CPU, for any
    non-decreasing ``row_group``. Returns the groups (n_blocks, block) i32
    and the kernel's ``swept`` output (n_blocks, 3) i32: per block, the
    chunks and grid rows staged and the (pixel, row) pairs swept, a pixel
    counted where its s0 is not NaN."""
    check_row_group(row_group, n_groups)
    inf = float("inf")
    n_blocks = band_of_block.shape[0]
    n_rows = u_half.shape[0]
    n_chunks = -(-n_rows // WGROUP)
    chunk_blocks = _chunk(chunk_blocks, block * u_half.numel())
    f = feats.reshape(n_blocks, block, 4)
    out = torch.full((n_blocks, block), n_groups - 1, dtype=torch.int32)
    swept = torch.zeros((n_blocks, 3), dtype=torch.int32)
    chunk_rows = [min(WGROUP, n_rows - WGROUP * c) for c in range(n_chunks)]
    # a chunk's rows of each chain: rows r = h (mod 4) below its height
    chain_rows = [torch.tensor([(rows - h + 3) // 4 for h in range(4)]) for rows in chunk_rows]
    # each (chunk, chain) row's group, the last rows' padded with the last group
    rg = torch.as_tensor(np.asarray(row_group), dtype=torch.int64)
    rg = torch.cat([rg, rg[-1:].expand(n_chunks * WGROUP - n_rows)])
    n_sets = block // 128
    running = torch.nonzero(~torch.isnan(f[:, :, 0]).all(1))[:, 0]  # not padding only
    for c0 in range(0, running.shape[0], chunk_blocks):
        sel = running[c0:c0 + chunk_blocks]
        fb = f[sel]
        rowmin = _row_minima(lut_c, u_half, v_half, fb, band_of_block[sel])
        pad = torch.full(rowmin.shape[:2] + (n_chunks * WGROUP - n_rows,), inf,
                         dtype=rowmin.dtype)
        # per (chunk, chain), the least (minimum, group) of the chain's rows:
        # row 16 c + 4 i + h is chain h's; rows ascend and their groups do
        # not decrease, so the first row at the minimum has the least group
        rm = torch.cat([rowmin, pad], -1).reshape(*rowmin.shape[:2], n_chunks, WGROUP // 4, 4)
        cmin, first = rm.min(3)
        cgrp = rg.reshape(n_chunks, WGROUP // 4, 4).expand(*rm.shape)
        cgrp = torch.gather(cgrp, 3, first[:, :, :, None])[:, :, :, 0]
        lbs = _lower_bounds_plain(fb.reshape(-1, 4), radii).reshape(-1, block, n_chunks)
        lives = ~torch.isnan(fb).any(-1)  # a NaN feature: only NaN costs, no chunk needed
        set_px = (~torch.isnan(fb[:, :, 0])).reshape(-1, n_sets, block // n_sets).sum(-1)
        for i, b in enumerate(sel.tolist()):
            lb, live = lbs[i], lives[i]
            best = torch.full((block, 4), inf, dtype=rowmin.dtype)
            best_g = torch.full((block, 4), 2 ** 31 - 1, dtype=torch.int64)
            known = torch.full((block,), inf, dtype=rowmin.dtype)  # merged best costs
            seen = known.clone()  # known when the need was last formed
            done = torch.zeros(n_chunks, dtype=torch.bool)
            if prune:
                least = torch.where(torch.isnan(lb), inf, lb).amin(-1, keepdim=True)
                need = (live[:, None] & (lb == least)).any(0)  # the home chunks
                home = torch.nonzero(need)[:, 0]
                center2 = int(home[0] + home[-1]) if home.numel() else -1
            else:
                need = torch.ones(n_chunks, dtype=torch.bool)
                center2 = -1  # ascending

            def choose(exclude=-1):
                cand = need & ~done
                if exclude >= 0:
                    cand[exclude] = False
                return _nearest_chunk(cand, center2)

            c = choose()
            while c >= 0:
                nxt = choose(exclude=c)
                if prune:
                    thr = torch.minimum(seen[:, None], best)
                    sets = (live[:, None] & ~(lb[:, c, None] > thr)).reshape(n_sets, -1, 4)
                    set_sweeps = sets.any(1)  # (set, chain)
                else:
                    set_sweeps = torch.ones((n_sets, 4), dtype=torch.bool)
                sweeps = set_sweeps.repeat_interleave(block // n_sets, 0)
                m, g = cmin[i, :, c], cgrp[i, :, c]
                take = sweeps & ((m < best) | ((m == best) & (g < best_g)))
                best.copy_(torch.where(take, m, best))
                best_g.copy_(torch.where(take, g, best_g))
                torch.minimum(known, best.amin(-1), out=known)
                swept[b, 0] += 1
                swept[b, 1] += chunk_rows[c]
                swept[b, 2] += int((set_sweeps * chain_rows[c] * set_px[i][:, None]).sum())
                done[c] = True
                if nxt >= 0:
                    done[nxt] = True
                if prune:
                    seen = known.clone()
                    need = (live[:, None] & ~(lb > seen[:, None])).any(0)
                c = nxt if nxt >= 0 else choose()
            # merge the chains by (minimum, group)
            low = best.amin(-1, keepdim=True)
            g_low = torch.where(best == low, best_g, 2 ** 31 - 1).amin(-1)
            out[b] = torch.where(low[:, 0] < inf, g_low, n_groups - 1).to(torch.int32)
    return out, swept


def _direct_slab_cost(lut_pad, u_half, v_half):
    """The direct-form slab cost ``cost(band, rows, fe)``: for blocks with
    LUT bands ``band`` (nb,), slab rows ``rows`` (nb, n_rows) and features
    ``fe`` (nb, block, >=4, 1, 1), the costs (nb, block, n_rows, P)."""
    def cost(band, rows, fe):
        return _cost(lut_pad[band[:, None], rows][:, None], u_half[rows][:, None],
                     v_half[rows][:, None], fe[:, :, 0], fe[:, :, 1], fe[:, :, 2], fe[:, :, 3])
    return cost


def _slab_argmin_plain(slab_cost, fb, band, r0, n_rows=SLAB_ROWS):
    """The slab sweep of K2, K3 and K5 for the blocks ``band``/``r0`` (nb,)
    with features ``fb`` (nb, block, >=4) over ``n_rows`` slab rows: per
    pixel the first strict minimum's flat index within the slab, whether it
    is a finite cost, and whether any cost is NaN (the reference's
    NaN-propagating min poisons it)."""
    rows = r0[:, None] + torch.arange(n_rows, device=fb.device)  # (nb, n_rows)
    j = slab_cost(band, rows, fb[:, :, :, None, None])
    j = j.reshape(j.shape[0], fb.shape[1], -1)
    poisoned = torch.isnan(j).any(-1)
    jc = torch.where(torch.isnan(j), float("inf"), j)
    flat = torch.argmin(jc, -1)
    hit = (torch.gather(jc, -1, flat[..., None])[..., 0] < float("inf")) & ~poisoned
    return flat, hit, poisoned


def _crosspol_plain(cr_row, w_half, s0_cr, dsig_cr, wco_half, has_co):
    """K2's and K4's crosspol argmin: rows ``cr_row`` (..., Wc) broadcast
    against per-pixel features (..., 1); the winning speed, 0 if any cost
    is NaN."""
    d = (cr_row - s0_cr) / dsig_cr
    j = _sq(d) + _sq(w_half - wco_half) * has_co
    poisoned = torch.isnan(j).any(-1)
    best = torch.argmin(torch.where(torch.isnan(j), float("inf"), j), -1)
    return torch.where(poisoned, 0.0, w_half[best] + w_half[best])


def _slab_refine_fused_plain(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats,
                             sband, srow0, vmask, has_cr, block, n_rows=SLAB_ROWS,
                             chunk_blocks=16, *, index):
    n_blocks = sband.shape[0]
    n_phi = lut_pad.shape[2]
    f = _slot_rows(feats, index, 8).reshape(n_blocks, block, 8)
    out = torch.zeros((n_blocks, 3, block), dtype=torch.float32, device=feats.device)
    slab_cost = _direct_slab_cost(lut_pad, u_half, v_half)
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        sel = torch.nonzero(vmask[b0:b1] != 0)[:, 0] + b0  # all-padding blocks stay 0
        if sel.numel() == 0:
            continue
        band = sband[sel].to(torch.int64)
        r0 = srow0[sel].to(torch.int64)
        fb = f[sel]  # (nb, block, 8)
        flat, hit, poisoned = _slab_argmin_plain(slab_cost, fb, band, r0, n_rows)
        row = r0[:, None] + torch.div(flat, n_phi, rounding_mode="floor")
        col = torch.where(poisoned, 0, flat % n_phi)
        wspd_co = torch.where(hit, w_pad[row], 0.0)
        out[sel, 0] = wspd_co
        out[sel, 1] = torch.where(poisoned, 0.0, co_phir[col])
        if has_cr:
            s0 = fb[:, :, 0]
            has_co = torch.where(torch.isnan(s0), 0.0, 1.0)[..., None]
            wco2 = torch.where(hit, w_pad[row] * 0.5, 0.0)[..., None] * has_co
            out[sel, 2] = _crosspol_plain(cr_lut[band][:, None], cr_whalf, fb[:, :, 4, None],
                                          fb[:, :, 5, None], wco2, has_co)
    return _to_pixels(out.permute(1, 0, 2).reshape(3, -1), index, feats.shape[0])


def _no_hit_flat(n_phi):
    """K3's index for a pixel with no finite cost: the reference's sweep
    init row ``(2**30 // n_phi) & ~1`` at phi lane 0."""
    return ((_NAN_IDX // n_phi) & ~1) * n_phi


def _slab_index_plain(slab_cost, n_phi, feats, sband, srow0, vmask, block, chunk_blocks,
                      n_rows=SLAB_ROWS):
    """K3's output (and K5's) from a slab cost (see :func:`_direct_slab_cost`):
    the winner's flat index with K3's sentinels, 0 in all-padding blocks."""
    n_blocks = sband.shape[0]
    f = feats.reshape(n_blocks, block, 4)
    out = torch.zeros((n_blocks, block), dtype=torch.int32, device=feats.device)
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        sel = torch.nonzero(vmask[b0:b1] != 0)[:, 0] + b0  # all-padding blocks stay 0
        if sel.numel() == 0:
            continue
        r0 = srow0[sel].to(torch.int64)
        flat, hit, poisoned = _slab_argmin_plain(slab_cost, f[sel], sband[sel].to(torch.int64),
                                                 r0, n_rows)
        idx = torch.where(hit, r0[:, None] * n_phi + flat, _no_hit_flat(n_phi))
        out[sel] = torch.where(poisoned, _NAN_IDX, idx).to(torch.int32)
    return out


def _slab_refine_plain(lut_pad, u_half, v_half, feats, sband, srow0, vmask, block,
                       n_rows=SLAB_ROWS, chunk_blocks=16, *, index):
    out = _slab_index_plain(_direct_slab_cost(lut_pad, u_half, v_half), lut_pad.shape[2],
                            _slot_rows(feats, index, 4), sband, srow0, vmask, block,
                            chunk_blocks, n_rows)
    return _to_pixels(out.reshape(-1), index, feats.shape[0])


def _crosspol_argmin_plain(cr_lut, w_half, feats, band_of_block, block, chunk_blocks=64, *,
                           index):
    n_blocks = band_of_block.shape[0]
    f = _slot_rows(feats, index, 4).reshape(n_blocks, block, 4, 1)
    out = torch.empty((n_blocks, block), dtype=torch.float32, device=feats.device)
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        fb = f[b0:b1]
        out[b0:b1] = _crosspol_plain(cr_lut[band_of_block[b0:b1].to(torch.int64)][:, None],
                                     w_half, fb[:, :, 0], fb[:, :, 1], fb[:, :, 2], fb[:, :, 3])
    return _to_pixels(out.reshape(-1), index, feats.shape[0])


def _below_merge_speed(re, im):
    """The merge's decision for one wind: its float32 modulus, rounded once
    from float64 (the squares exact, the sum and root correctly rounded), is
    below ``MERGE_BELOW``. A NaN modulus is not below."""
    re, im = re.double(), im.double()
    return torch.sqrt(re * re + im * im).to(torch.float32) < MERGE_BELOW


def _dual_merge_plain(co_re, co_im, du_re, du_im):
    take_co = _below_merge_speed(co_re, co_im) | _below_merge_speed(du_re, du_im)
    return (torch.complex(co_re, co_im),
            torch.complex(torch.where(take_co, co_re, du_re), torch.where(take_co, co_im, du_im)))


def _f32_sort_key_plain(v):
    bits = v.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    key = torch.where(torch.isinf(v), torch.iinfo(torch.int32).min, key)
    return torch.where(torch.isnan(v), torch.iinfo(torch.int32).max, key)


def _sort_pairs_plain(keys, values):
    ks, order = torch.sort(keys, stable=True)
    return ks, order.to(torch.int32) if values is None else values[order]


# ---------------------------------------------------------- build and bind

_lib_lock = threading.Lock()
_lib = None
build_log = ""


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _included(source):
    """``source`` and the ``csrc/`` headers it includes, directly or not."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.append(name)
            todo += re.findall(r'^#include "([^"]+)"', (_CSRC / name).read_text(), re.M)
    return seen


def build_kernels(sources=_SOURCES, name="inversion"):
    """Compile the ``csrc/`` ``sources`` into one shared library,
    ``libxsarsea_<name>_<hash>.so`` (once per content of the sources and the
    headers they include, flags and nvcc version), and return its path: by
    default the main path's library. ``build_log`` holds the compiler's
    output of the last build this call made (empty when the library was
    there already). A failed build raises."""
    global build_log
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout
    h = hashlib.sha256((" ".join(_NVCC_FLAGS) + version).encode())
    for path in sorted({f for src in sources for f in _included(src)}):
        h.update(path.encode() + (_CSRC / path).read_bytes())
    build_dir = _build_dir()
    lib = build_dir / f"libxsarsea_{name}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        build_log = ""
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _bind(path, entries):
    """The library at ``path`` with each entry point of ``entries`` (name ->
    argument types) returning an int CUDA error code, which its
    ``xs_error_string`` names."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.xs_error_string.argtypes = [ctypes.c_int]
    lib.xs_error_string.restype = ctypes.c_char_p
    return lib


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    "xs_group_argmin": [_p] * 6 + [_i] + [_p] * 2 + [_i] * 5 + [_p],
    "xs_group_argmin_streamed": [_p] * 7 + [_i] + [_p] * 3 + [_i] * 6 + [_p],
    "xs_slab_refine_fused": [_p] * 9 + [_i] + [_p] * 4 + [_ll] + [_i] * 8 + [_p],
    "xs_slab_refine": [_p] * 5 + [_i] + [_p] * 4 + [_i] * 7 + [_p],
    "xs_crosspol_argmin": [_p] * 4 + [_i] + [_p] * 2 + [_i] * 3 + [_p],
    "xs_chunk_lower_bounds": [_p] * 3 + [_i] * 2 + [_p],
    "xs_dual_merge": [_p] * 6 + [_ll, _p],
    "xs_f32_sort_key": [_p, _p, _ll, _p],
    "xs_radix_sort_temp_bytes": [_ll, _i, _p],
    "xs_radix_sort_pairs": [_p, ctypes.c_ulonglong] + [_p] * 4 + [_ll, _i, _p],
}


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            spans.count("builds")
            with spans.span("xs.build"):
                _lib = _bind(build_kernels(), _ENTRIES)
    return _lib


def _check(lib, rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.xs_error_string(rc).decode()})")


def _require(t, name, dtype, shape=None):
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor, got {t.dtype}"
                         f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _cuda_args(device, named):
    for name, (t, dtype, shape) in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the launch is on {device}")
        _require(t, name, dtype, shape)


def _check_ranges(*guards):
    """A launch's range guards, ``(index, lo, hi, name)`` each: the values
    the kernel dereferences must lie in ``[lo, hi)``, else ``ValueError``.
    The indices not marked by :func:`mark_in_range` are read back together,
    one host wait for the launch (counter ``range_checks``); a launch with
    nothing to read back counts under ``range_checks_waived``."""
    todo = [g for g in guards if g[0].numel() and not _marked_in(*g[:3])]
    if not todo:
        spans.count("range_checks_waived")
        return
    spans.count("range_checks")
    ext = torch.stack([torch.stack(torch.aminmax(t)).to(torch.int64) for t, *_ in todo]).tolist()
    for (_, lo, hi, name), (mn, mx) in zip(todo, ext):
        if mn < lo or mx >= hi:
            raise ValueError(f"{name} values [{mn}, {mx}] outside [{lo}, {hi})")


def _count_rows(n_slots):
    """A launch's ``n_slots`` slots, read through the bucket permutation
    (counter ``perm_rows_read``): from shapes, no host wait."""
    spans.count("perm_rows_read", n_slots)


def _rows_args(name, feats, index, n_slots, width, vector=False):
    """Check a launch's feature rows, ``index`` (n_slots,) int64 on
    ``feats``' device and ``feats`` the pixel table (n_px, C), C >= width,
    and return the row stride in floats. ``vector``: the kernel reads a
    row's first 4 floats as one 16-byte load. The index's values, in [-1,
    n_px), are the caller's to keep (bucketing makes them so); checking them
    would cost a host wait a launch."""
    _cuda_args(feats.device, {"index": (index, torch.int64, (n_slots,))})
    _require(feats, "feats", torch.float32)
    if feats.dim() != 2 or feats.shape[1] < width:
        raise ValueError(f"{name}: the rows table must be (n_px, >= {width}), "
                         f"got {tuple(feats.shape)}")
    if vector and (feats.shape[1] % 4 or feats.data_ptr() % 16):
        raise ValueError(f"{name}: feats needs 16-byte aligned rows of a multiple of 4 floats, "
                         f"got {feats.shape[1]} floats at {feats.data_ptr() % 16} bytes")
    return feats.shape[1]


# ------------------------------------------------------------------ wrappers

def k1_staged_fits(n_rows, n_cols):
    """Whether K1's staged form can hold an ``n_rows`` x ``n_cols`` grid in
    a block's shared memory (its three planes, row groups and partials, and
    the features it gathers)."""
    ld = (n_cols + 3) & ~3
    floats = (3 * n_rows * ld + 2 * 4 * GROUP_BLOCK + n_rows + 3) & ~3
    return (floats + 4 * GROUP_BLOCK) * 4 <= _SMEM_OPTIN


def group_argmin(lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                 block=GROUP_BLOCK, *, index):
    """K1: first-minimum wspd group per pixel over a grid of LUT cells, the
    grid held whole in shared memory (the fused mode's coarse grid).

    lut_c (I, R, C), u_half/v_half (R, C) f32 and row_group (R,) i32 come
    from :func:`build_coarse_arrays`; feats (n_px, C) f32, the pixel table,
    C a multiple of 4 (the fused tail's 8), whose rows' first 4 floats are
    (s0_db, ma/2, mz/2, 1/dsig); ``index`` (n_blocks*block,) int64, the
    bucket permutation: slot s reads row ``index[s]`` (NaN features where it
    is -1); band_of_block (n_blocks,) band per block. Returns (n_blocks,
    block) i32 in slot order; pixels with no finite cost get ``n_groups -
    1``. The kernel takes blocks of ``GROUP_BLOCK`` pixels, a non-decreasing
    ``row_group`` (each of its chains meets its groups in ascending order;
    checked once per table, :func:`check_row_group`) and a grid that fits a
    block's shared memory (:func:`k1_staged_fits`); the plain version takes
    any.
    """
    return _group_argmin("group_argmin", lut_c, u_half, v_half, row_group, feats,
                         band_of_block, n_groups, block, index=index)


def group_argmin_streamed(lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                          block=GROUP_BLOCK, *, index, radii, swept=None, _prune=True):
    """K1's streamed form: :func:`group_argmin` on a grid of any height, its
    rows streamed through shared memory 16 at a time (the fused_exact mode's
    full grid, built by :func:`build_coarse_arrays` at strides 1, or a coarse
    grid too large for the staged form). Same arguments and result.

    The kernel sweeps only the chunks of 16 rows a pixel can still win in, by
    an exact lower bound on their costs (csrc/group_argmin.cu's note): the
    answer is the unpruned one, bit for bit, for any non-decreasing
    ``row_group``. ``radii``: the grid's ``(ceil(R / 16), 2)`` f32 annuli of
    :func:`build_chunk_radii`, built once per grid, on the card. ``swept``,
    an optional ``(n_blocks, 3)`` int32 card tensor, receives each block's
    chunks and grid rows staged and (pixel, row) pairs swept, a pixel
    counted where its s0 is not NaN. ``_prune=False`` sweeps every chunk (A/B
    and tests). The plain version ignores these three."""
    return _group_argmin("group_argmin_streamed", lut_c, u_half, v_half, row_group, feats,
                         band_of_block, n_groups, block, radii, swept, _prune, index=index)


def chunk_lower_bounds(feats, radii):
    """The streamed K1's lower bound per (pixel, chunk): ``(n, n_chunks)``
    f32 from feats (n, 4) and radii (n_chunks, 2). On a CUDA tensor the
    kernel's own device function computes it; on a CPU tensor its float64
    emulation. On no path of the inversion; counts no launch."""
    if feats.device.type == "cpu":
        return _lower_bounds_plain(feats, radii)
    if feats.device.type != "cuda":
        raise ValueError(f"chunk_lower_bounds: unsupported device {feats.device}")
    n, n_chunks = feats.shape[0], radii.shape[0]
    _cuda_args(feats.device, {"feats": (feats, torch.float32, (n, 4)),
                              "radii": (radii, torch.float32, (n_chunks, 2))})
    out = torch.empty((n, n_chunks), dtype=torch.float32, device=feats.device)
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_chunk_lower_bounds(feats.data_ptr(), radii.data_ptr(), out.data_ptr(), n,
                                       n_chunks, stream)
    _check(lib, rc, "chunk_lower_bounds")
    return out


def _group_argmin(name, lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                  block, radii=None, swept=None, prune=True, *, index):
    n_blocks = band_of_block.shape[0]
    band_guard = (band_of_block, 0, lut_c.shape[0], "band_of_block")
    if feats.device.type == "cpu":
        _check_ranges(band_guard)
        _count_rows(n_blocks * block)
        return _group_argmin_plain(lut_c, u_half, v_half, row_group, feats, band_of_block,
                                   n_groups, block, index=index)
    if feats.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {feats.device}")
    streamed = name == "group_argmin_streamed"
    n_rows, n_cols = u_half.shape
    band = band_of_block.to(torch.int32)
    _cuda_args(feats.device, {
        "lut_c": (lut_c, torch.float32, (lut_c.shape[0], n_rows, n_cols)),
        "u_half": (u_half, torch.float32, None),
        "v_half": (v_half, torch.float32, (n_rows, n_cols)),
        "row_group": (row_group, torch.int32, (n_rows,)),
        "band_of_block": (band, torch.int32, None)})
    stride = _rows_args(name, feats, index, n_blocks * block, 4, vector=True)
    if block != GROUP_BLOCK:
        raise ValueError(f"{name}: the kernel takes blocks of {GROUP_BLOCK} pixels")
    if not streamed and not k1_staged_fits(n_rows, n_cols):
        raise ValueError(f"group_argmin: a {n_rows} x {n_cols} grid does not fit a block's "
                         "shared memory; use group_argmin_streamed")
    if not _row_group_checked(row_group, n_groups):
        check_row_group(row_group, n_groups)
    _check_ranges(band_guard)
    out = torch.empty((n_blocks, block), dtype=torch.int32, device=feats.device)
    lib = _load()
    if streamed:
        named = {"radii": (radii, torch.float32, (-(-n_rows // WGROUP), 2))}
        if swept is not None:
            named["swept"] = (swept, torch.int32, (n_blocks, 3))
        _cuda_args(feats.device, named)
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.xs_group_argmin_streamed(
                lut_c.data_ptr(), u_half.data_ptr(), v_half.data_ptr(), row_group.data_ptr(),
                radii.data_ptr(), feats.data_ptr(), index.data_ptr(), stride, band.data_ptr(),
                out.data_ptr(), None if swept is None else swept.data_ptr(), n_blocks, block,
                n_rows, n_cols, n_groups, int(bool(prune)), stream)
    else:
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.xs_group_argmin(
                lut_c.data_ptr(), u_half.data_ptr(), v_half.data_ptr(), row_group.data_ptr(),
                feats.data_ptr(), index.data_ptr(), stride, band.data_ptr(), out.data_ptr(),
                n_blocks, block, n_rows, n_cols, n_groups, stream)
    _check(lib, rc, name)
    _count(name)
    _count_rows(n_blocks * block)
    return out


def _check_rows(n_rows, wp_rows, name):
    if not 1 <= n_rows <= wp_rows:
        raise ValueError(f"{name}: n_rows {n_rows} outside [1, {wp_rows}]")


def _check_chunk_rows(chunk_rows, name):
    if chunk_rows not in CHUNK_ROWS:
        raise ValueError(f"{name}: chunk_rows {chunk_rows!r} not in {CHUNK_ROWS}")


def slab_smem_bytes(n_phi, n_rows, chunk_rows=8, planes=3):
    """Dynamic shared memory of a slab sweep's block (``xs::slab::smem_bytes``
    in csrc/inversion_common.cuh): two stages of ``planes`` operand planes of
    ``chunk_rows`` rows (one stage when the slab is a single chunk), rows
    padded to a multiple of 4 floats, at least the per-warp partial minima."""
    stages = (2 if n_rows > chunk_rows else 1) * planes * chunk_rows * ((n_phi + 3) & ~3)
    return 4 * max(stages, 2 * 4 * SLAB_BLOCK)


def _check_smem(n_bytes, name):
    """Refuse a sweep whose block would need more shared memory than sm_90
    lets a block opt in to (it would never launch)."""
    if n_bytes > _SMEM_OPTIN:
        raise ValueError(f"{name}: a block needs {n_bytes} bytes of shared memory, more than "
                         f"the {_SMEM_OPTIN} a block may opt in to")


def _slab_guards(lut_pad, sband, srow0, n_rows):
    """K2's and K3's range guards: a block's band and its slab's first row."""
    n_inc, wp_rows = lut_pad.shape[:2]
    return (sband, 0, n_inc, "sband"), (srow0, 0, wp_rows - n_rows + 1, "srow0")


def slab_refine_fused(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats, sband,
                      srow0, vmask, has_cr=True, block=SLAB_BLOCK, n_rows=SLAB_ROWS, *, index,
                      chunk_rows=8):
    """K2: slab refine + decode + crosspol argmin per (band, group) block.

    lut_pad (I, Wp, P), u_half/v_half (Wp, P) from
    :func:`build_direct_arrays`; w_pad (Wp,) wspd per row; co_phir (P,)
    phi in radians; cr_lut (I, Wc), cr_whalf (Wc,) from
    :func:`build_crosspol_arrays` (ignored with ``has_cr=False``); feats
    (n_px, C >= 8) f32, the pixel table, rows (s0_db, ma/2, mz/2, 1/dsig,
    s0_cr_db, dsig_cr, 0, 0); ``index`` (n_blocks*block,) int64, the bucket
    permutation: slot s reads row ``index[s]`` (NaN features where it is
    -1); sband, srow0, vmask (n_blocks,): LUT band, first of the ``n_rows``
    slab rows (48 in the fused mode, 32 in fused_exact) and a 0 for
    all-padding blocks. Returns (3, n_px) f32 in pixel order, rows (wspd_co,
    phi, wspd_cr) written at ``index[s]`` (0 at a pixel no slot names, or
    whose block is all padding; every pixel in at most one slot).
    A pixel whose slab costs hold a NaN gets (0, 0); its crosspol cost
    likewise gives 0. ``chunk_rows`` (:data:`CHUNK_ROWS`): the slab rows a
    shared-memory stage of the kernel's sweep holds; every value gives the
    same bits (no path passes it; ``scripts/bench_slab_variants.py`` times
    them). A height whose stages do not fit a block's shared memory is
    refused with the bytes it needs.
    """
    n_blocks = sband.shape[0]
    _check_chunk_rows(chunk_rows, "slab_refine_fused")
    if feats.device.type == "cpu":
        _check_ranges(*_slab_guards(lut_pad, sband, srow0, n_rows))
        _count_rows(n_blocks * block)
        return _slab_refine_fused_plain(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut,
                                        cr_whalf, feats, sband, srow0, vmask, has_cr, block,
                                        n_rows, index=index)
    if feats.device.type != "cuda":
        raise ValueError(f"slab_refine_fused: unsupported device {feats.device}")
    n_inc, wp_rows, n_phi = lut_pad.shape
    n_cr = cr_whalf.shape[0]
    i32 = [x.to(torch.int32) for x in (sband, srow0, vmask)]
    _cuda_args(feats.device, {
        "lut_pad": (lut_pad, torch.float32, None),
        "u_half": (u_half, torch.float32, (wp_rows, n_phi)),
        "v_half": (v_half, torch.float32, (wp_rows, n_phi)),
        "w_pad": (w_pad, torch.float32, (wp_rows,)),
        "co_phir": (co_phir, torch.float32, (n_phi,)),
        "cr_lut": (cr_lut, torch.float32, (n_inc, n_cr) if has_cr else None),
        "cr_whalf": (cr_whalf, torch.float32, None),
        "sband": (i32[0], torch.int32, None), "srow0": (i32[1], torch.int32, None),
        "vmask": (i32[2], torch.int32, None)})
    stride = _rows_args("slab_refine_fused", feats, index, n_blocks * block, 8)
    if block != SLAB_BLOCK:
        raise ValueError(f"slab_refine_fused: the kernel takes blocks of {SLAB_BLOCK} pixels")
    _check_rows(n_rows, wp_rows, "slab_refine_fused")
    smem = slab_smem_bytes(n_phi, n_rows, chunk_rows)
    _check_smem(max(smem, 8 * ((n_cr + 3) & ~3)) if has_cr else smem, "slab_refine_fused")
    _check_ranges(*_slab_guards(lut_pad, sband, srow0, n_rows))
    n_px = feats.shape[0]
    out = torch.zeros((3, n_px), dtype=torch.float32, device=feats.device)
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_slab_refine_fused(
            lut_pad.data_ptr(), u_half.data_ptr(), v_half.data_ptr(), w_pad.data_ptr(),
            co_phir.data_ptr(), cr_lut.data_ptr(), cr_whalf.data_ptr(), feats.data_ptr(),
            index.data_ptr(), stride, i32[0].data_ptr(), i32[1].data_ptr(), i32[2].data_ptr(),
            out.data_ptr(), n_px, n_blocks, block, wp_rows, n_phi, n_rows, n_cr,
            int(bool(has_cr)), chunk_rows, stream)
    _check(lib, rc, "slab_refine_fused")
    _count("slab_refine_fused", chunk_rows)
    _count_rows(n_blocks * block)
    return out


def slab_refine(lut_pad, u_half, v_half, feats, sband, srow0, vmask, block=SLAB_BLOCK,
                n_rows=SLAB_ROWS, *, index, chunk_rows=8):
    """K3: slab refine per (band, group) block, emitting the flat index.

    lut_pad (I, Wp, P), u_half/v_half (Wp, P) from
    :func:`build_direct_arrays`; feats (n_px, C >= 4) f32, the pixel table,
    rows (s0_db, ma/2, mz/2, 1/dsig); ``index``, sband, srow0, vmask and
    ``n_rows`` as for :func:`slab_refine_fused`. Returns (n_px,) i32 in
    pixel order: the winner's row-major index ``row * P + col`` into the
    true (W, P) grid; ``2**30`` for a pixel whose slab costs hold a NaN and
    ``((2**30 // P) & ~1) * P`` for one with no finite cost (the reference's
    sentinels: clip before use as an index); 0 at a pixel no slot names or
    whose block is all padding. ``chunk_rows`` as for
    :func:`slab_refine_fused`.
    """
    n_blocks = sband.shape[0]
    _check_chunk_rows(chunk_rows, "slab_refine")
    if feats.device.type == "cpu":
        _check_ranges(*_slab_guards(lut_pad, sband, srow0, n_rows))
        _count_rows(n_blocks * block)
        return _slab_refine_plain(lut_pad, u_half, v_half, feats, sband, srow0, vmask, block,
                                  n_rows, index=index)
    if feats.device.type != "cuda":
        raise ValueError(f"slab_refine: unsupported device {feats.device}")
    _, wp_rows, n_phi = lut_pad.shape
    i32 = [x.to(torch.int32) for x in (sband, srow0, vmask)]
    _cuda_args(feats.device, {
        "lut_pad": (lut_pad, torch.float32, None),
        "u_half": (u_half, torch.float32, (wp_rows, n_phi)),
        "v_half": (v_half, torch.float32, (wp_rows, n_phi)),
        "sband": (i32[0], torch.int32, None), "srow0": (i32[1], torch.int32, None),
        "vmask": (i32[2], torch.int32, None)})
    stride = _rows_args("slab_refine", feats, index, n_blocks * block, 4)
    if block != SLAB_BLOCK:
        raise ValueError(f"slab_refine: the kernel takes blocks of {SLAB_BLOCK} pixels")
    _check_rows(n_rows, wp_rows, "slab_refine")
    _check_smem(slab_smem_bytes(n_phi, n_rows, chunk_rows), "slab_refine")
    _check_ranges(*_slab_guards(lut_pad, sband, srow0, n_rows))
    out = torch.zeros(feats.shape[0], dtype=torch.int32, device=feats.device)
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_slab_refine(
            lut_pad.data_ptr(), u_half.data_ptr(), v_half.data_ptr(), feats.data_ptr(),
            index.data_ptr(), stride, i32[0].data_ptr(), i32[1].data_ptr(), i32[2].data_ptr(),
            out.data_ptr(), n_blocks, block, wp_rows, n_phi, n_rows, _no_hit_flat(n_phi),
            chunk_rows, stream)
    _check(lib, rc, "slab_refine")
    _count("slab_refine", chunk_rows)
    _count_rows(n_blocks * block)
    return out


def crosspol_argmin(cr_lut, w_half, feats, band_of_block, block=CR_BLOCK, *, index):
    """K4: crosspol wind-speed argmin per block sharing one crosspol band.

    cr_lut (I, Wc), w_half (Wc,) from :func:`build_crosspol_arrays`; feats
    (n_px, C) f32, the pixel table, C a multiple of 4, whose rows' first 4
    floats are (s0_cr_db, dsig_cr, wco/2, has_co) with wco/2 = 0 where
    has_co = 0; ``index`` (n_blocks*block,) int64, the bucket permutation:
    slot s reads row ``index[s]`` (NaN features where it is -1);
    band_of_block (n_blocks,) crosspol band per block. Returns (n_px,) f32
    in pixel order: the first-minimum wind speed in m/s, 0 where any cost is
    NaN or at a pixel no slot names (every pixel in at most one slot). The
    kernel takes blocks of ``CR_BLOCK`` pixels; the plain version takes any.
    """
    n_blocks = band_of_block.shape[0]
    band_guard = (band_of_block, 0, cr_lut.shape[0], "band_of_block")
    if feats.device.type == "cpu":
        _check_ranges(band_guard)
        _count_rows(n_blocks * block)
        return _crosspol_argmin_plain(cr_lut, w_half, feats, band_of_block, block, index=index)
    if feats.device.type != "cuda":
        raise ValueError(f"crosspol_argmin: unsupported device {feats.device}")
    n_cr = cr_lut.shape[1]
    band = band_of_block.to(torch.int32)
    _cuda_args(feats.device, {
        "cr_lut": (cr_lut, torch.float32, None),
        "w_half": (w_half, torch.float32, (n_cr,)),
        "band_of_block": (band, torch.int32, None)})
    stride = _rows_args("crosspol_argmin", feats, index, n_blocks * block, 4, vector=True)
    if block != CR_BLOCK:
        raise ValueError(f"crosspol_argmin: the kernel takes blocks of {CR_BLOCK} pixels")
    _check_ranges(band_guard)
    out = torch.zeros(feats.shape[0], dtype=torch.float32, device=feats.device)
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_crosspol_argmin(cr_lut.data_ptr(), w_half.data_ptr(), feats.data_ptr(),
                                    index.data_ptr(), stride, band.data_ptr(), out.data_ptr(),
                                    n_blocks, block, n_cr, stream)
    _check(lib, rc, "crosspol_argmin")
    _count("crosspol_argmin")
    _count_rows(n_blocks * block)
    return out


def dual_merge(co_re, co_im, du_re, du_im):
    """The dual-pol merge of one piece's winds, packed into complex64.

    co_re, co_im, du_re, du_im: the float32 planes of the copol and dual-pol
    winds, one shape. Returns ``(wind_co, wind_dual)`` complex64 of that
    shape: ``wind_co = co_re + i co_im``; ``wind_dual`` the copol wind where
    either wind's float32 modulus, rounded once from float64, is below
    ``MERGE_BELOW`` (5 m/s), else ``du_re + i du_im``. A NaN modulus is not
    below. The values are the planes' own bits. On a CUDA tensor the
    ``dual_merge`` kernel runs (csrc/dual_merge.cu) and counts its pixels
    under ``merge_px_card``; on a CPU tensor its plain version.
    """
    planes = {"co_re": co_re, "co_im": co_im, "du_re": du_re, "du_im": du_im}
    if co_re.device.type == "cpu":
        return _dual_merge_plain(co_re, co_im, du_re, du_im)
    if co_re.device.type != "cuda":
        raise ValueError(f"dual_merge: unsupported device {co_re.device}")
    _cuda_args(co_re.device, {name: (t, torch.float32, co_re.shape)
                              for name, t in planes.items()})
    wind_co = torch.empty(co_re.shape, dtype=torch.complex64, device=co_re.device)
    wind_dual = torch.empty_like(wind_co)
    lib = _load()
    with torch.cuda.device(co_re.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_dual_merge(*(t.data_ptr() for t in planes.values()), wind_co.data_ptr(),
                               wind_dual.data_ptr(), co_re.numel(), stream)
    _check(lib, rc, "dual_merge")
    _count("dual_merge")
    spans.count("merge_px_card", co_re.numel())
    return wind_co, wind_dual


def f32_sort_key(v):
    """The 32-bit order-preserving key of float32 ``v``, int32 of its shape:
    ``bucketing._f32_sort_key_np``'s, the JAX package's unsigned key less
    2**31, so that torch's (signed) order of it is that key's. Negatives
    flip, -0 sorts below +0, +-inf gives the least key and NaN the largest.
    On a CUDA tensor the ``f32_sort_key`` kernel writes it
    (csrc/bucket_sort.cu), counted as ``launch/f32_sort_key``; on a CPU
    tensor its plain version."""
    if v.dtype != torch.float32:
        raise ValueError(f"f32_sort_key: need float32 values, got {v.dtype}")
    if v.device.type == "cpu":
        return _f32_sort_key_plain(v)
    if v.device.type != "cuda":
        raise ValueError(f"f32_sort_key: unsupported device {v.device}")
    bits = v.contiguous().view(torch.int32)
    key = torch.empty_like(bits)
    lib = _load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_f32_sort_key(bits.data_ptr(), key.data_ptr(), bits.numel(), stream)
    _check(lib, rc, "f32_sort_key")
    _count("f32_sort_key")
    return key


def sort_pairs(keys, end_bit, values=None):
    """Stable sort of int32 ``keys`` (n,) over their bits ``[0, end_bit)``,
    with an int32 payload carried: ``values`` (n,), or each key's index
    where it is None. Returns ``(sorted keys, payload in key order)``. At
    ``end_bit`` 32 the keys compare as int32; below it they must lie in
    ``[0, 2**end_bit)``, where that order is theirs. Equal keys keep their
    order, so the result is ``torch.sort(keys, stable=True)``'s with the
    payload gathered by its indices. On a CUDA tensor cub's radix sort runs
    (csrc/bucket_sort.cu) in ``ceil(end_bit / 8)`` passes, its temporary
    storage taken from torch's allocator, on the current stream, with no
    host wait, counted as ``launch/sort_pairs``; on a CPU tensor
    ``torch.sort``. Counts the sort (``narrow_sorts``) and its key bits
    (``sort_bits``) on either."""
    if not 1 <= end_bit <= 32:
        raise ValueError(f"sort_pairs: end_bit must lie in [1, 32], got {end_bit}")
    spans.count("narrow_sorts")
    spans.count("sort_bits", end_bit)
    if keys.device.type == "cpu":
        return _sort_pairs_plain(keys, values)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_pairs: unsupported device {keys.device}")
    n = keys.shape[0]
    named = {"keys": keys} if values is None else {"keys": keys, "values": values}
    _cuda_args(keys.device, {name: (t, torch.int32, (n,)) for name, t in named.items()})
    ks, vs = torch.empty_like(keys), torch.empty_like(keys)
    if n == 0:
        return ks, vs
    lib = _load()
    temp_bytes = ctypes.c_ulonglong()
    _check(lib, lib.xs_radix_sort_temp_bytes(n, end_bit, ctypes.byref(temp_bytes)), "sort_pairs")
    temp = torch.empty(temp_bytes.value, dtype=torch.uint8, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        if values is None:
            values = torch.arange(n, dtype=torch.int32, device=keys.device)
        rc = lib.xs_radix_sort_pairs(temp.data_ptr(), temp_bytes.value, keys.data_ptr(),
                                     ks.data_ptr(), values.data_ptr(), vs.data_ptr(), n,
                                     end_bit, stream)
    _check(lib, rc, "sort_pairs")
    _count("sort_pairs")
    return ks, vs


def _group_argmin_streamed_plain(lut_c, u_half, v_half, row_group, feats, band_of_block,
                                 n_groups, block=GROUP_BLOCK, radii=None, swept=None,
                                 _prune=True, chunk_blocks=16, *, index):
    """K1's streamed form has K1's plain version, unpruned: pruning leaves
    every answer as it is. ``radii``, ``swept`` and ``_prune`` are the
    kernel's and are ignored."""
    return _group_argmin_plain(lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                               block, chunk_blocks, index=index)


KERNELS = {"group_argmin": group_argmin, "group_argmin_streamed": group_argmin_streamed,
           "slab_refine_fused": slab_refine_fused, "slab_refine": slab_refine,
           "crosspol_argmin": crosspol_argmin}
_LAUNCH = "launch/"  # the launch counters' prefix among the port's counters


def _count(name, chunk_rows=8):
    """One launch of ``name``; K2/K3 at a chunk height other than 8 count
    apart, as ``<name>:chunk_rows=<rows>``."""
    spans.count(_LAUNCH + (name if chunk_rows == 8 else f"{name}:chunk_rows={chunk_rows}"))


def reset_launch_counts():
    spans.reset(_LAUNCH)


def launch_counts():
    """Kernel launches per wrapper since the last reset (plain-version
    calls on the CPU do not count); K2/K3 at a chunk height other than 8
    under ``<name>:chunk_rows=<rows>``; ``dual_merge``, ``f32_sort_key``
    and ``sort_pairs``, which are not among :data:`KERNELS` (the argmin
    kernels), present once launched. The counters
    are the port's ``launch/<name>`` (:mod:`xsarsea_tpu_torch.utils.spans`)."""
    return {**dict.fromkeys(KERNELS, 0), **spans.counters(_LAUNCH)}
