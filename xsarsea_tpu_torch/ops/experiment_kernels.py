"""The experiment kernels of ``scripts/``, their plain versions and operands.

* K5 :func:`slab_forms` replaces ``run_form`` (``scripts/bench_slab_forms.py``):
  K3's slab sweep in one of three cost forms, emitting K3's flat index.
  ``direct`` is K3's cost; ``prescaled`` folds ``inv_dsig`` into the LUT and
  the pixel's sigma0 beforehand; ``expanded_uv`` also expands the wind terms
  against a per-entry row ``kr = (u/2)^2 + (v/2)^2``. The two rewrites round
  differently, so near-ties can flip: the driver
  (``xsarsea_tpu_torch/scripts/bench_slab_forms.py``) counts the flips.
* K6 :func:`group_argmin_variant` replaces ``make_variant.run``
  (``scripts/bench_kernel_variants.py``): the TPU's coarse pass as a K = 4
  product ``g4[band, tile]^T . feats``, reduced to 32 group rows per pixel,
  then the first row holding the minimum, in the variants of matmul
  precision, group-min reduction and block size that the driver
  (``xsarsea_tpu_torch/scripts/bench_kernel_variants.py``) times.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/slab_forms.cu``, ``csrc/group_argmin_variants.cu``, built into the
library of :mod:`xsarsea_tpu_torch.ops.inversion_kernels`) or raises; on a
CPU tensor it runs the plain PyTorch version, one torch op per kernel
operation. Each wrapper counts its launches per form or variant
(:func:`launch_counts`).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from xsarsea_tpu_torch.ops import inversion_kernels as K

__all__ = [
    "FORMS",
    "G4_TILES",
    "G4_TILE",
    "GROUP_SIZE",
    "PRECISIONS",
    "REDUCTIONS",
    "VARIANT_BLOCKS",
    "build_form_arrays",
    "group_argmin_variant",
    "launch_counts",
    "reset_launch_counts",
    "slab_forms",
    "variant_name",
]

FORMS = ("direct", "prescaled", "expanded_uv")

G4_TILES = 4  # tiles of the coarse operand per band (grid axis 1 of the TPU kernel)
G4_TILE = 2048  # entries per tile
GROUP_SIZE = 256  # entries per wind-speed group
_GROUPS_PER_TILE = G4_TILE // GROUP_SIZE
_N_GROUPS = G4_TILES * _GROUPS_PER_TILE  # 32 scratch rows per pixel
VARIANT_BLOCKS = (256, 512, 1024)
PRECISIONS = ("highest", "default")
# reshape and static_slices are two TPU codegen routes to one function
REDUCTIONS = ("reshape", "static_slices", "flat_min", "none")
_REDUCTION_CODE = {"reshape": 0, "static_slices": 0, "flat_min": 1, "none": 2}

_launches = Counter()


def reset_launch_counts():
    _launches.clear()


def launch_counts():
    """Kernel launches per form (``slab_forms/<form>``) and variant
    (``group_argmin_variant/<variant_name>``) since the last reset;
    plain-version calls on the CPU do not count."""
    return dict(_launches)


def variant_name(block, reduction, precision):
    return f"block={block},{reduction},{precision}"


# ------------------------------------------------------------------ operands

def build_form_arrays(form, lut_db, u, v, dsig_co):
    """K5 operands ``(lut (I, Wp, P), u (Wp, P), v (Wp, P), kr (Wp, P) or
    None)`` f32 for ``form``, from :func:`K.build_direct_arrays`.

    ``direct``: K3's operands. ``prescaled``: the padded LUT times
    ``inv_dsig = f32(1 / dsig_co)`` (padding rows become 1e20: their cost
    still overflows to +inf). ``expanded_uv``: the prescaled LUT,
    ``u2 = -2 * u/2``, ``v2 = -2 * v/2`` (exact) and ``kr = (u/2)^2 +
    (v/2)^2`` rounded f32, as ``scripts/bench_slab_forms.py:210-216``
    builds them in its packed layout.
    """
    lut_pad, u_half, v_half = K.build_direct_arrays(lut_db, u, v)
    if form == "direct":
        return lut_pad, u_half, v_half, None
    lut_s = lut_pad * np.float32(1.0 / dsig_co)
    if form == "prescaled":
        return lut_s, u_half, v_half, None
    if form == "expanded_uv":
        kr = u_half * u_half + v_half * v_half
        return lut_s, np.float32(-2.0) * u_half, np.float32(-2.0) * v_half, kr
    raise ValueError(f"unknown slab cost form {form!r}; expected one of {FORMS}")


# ------------------------------------------------------------ plain versions

def _form_slab_cost(form, lut, u, v, kr):
    """The slab cost of ``form`` in K3's ``cost(band, rows, fe)`` shape."""
    if form == "direct":
        return K._direct_slab_cost(lut, u, v)

    def cost(band, rows, fe):
        l = lut[band[:, None], rows][:, None]  # noqa: E741
        ur, vr = u[rows][:, None], v[rows][:, None]
        s0, ma2, mz2 = fe[:, :, 0], fe[:, :, 1], fe[:, :, 2]
        if form == "prescaled":
            return (K._sq(l - s0) + K._sq(ur - ma2)) + K._sq(vr - mz2)
        t = l - s0
        return ((t * t + kr[rows][:, None]) + ur * ma2) + vr * mz2
    return cost


def _slab_forms_plain(form, lut, u, v, kr, feats, sband, srow0, vmask, block=K.SLAB_BLOCK,
                      chunk_blocks=16):
    return K._slab_index_plain(_form_slab_cost(form, lut, u, v, kr), lut.shape[2], feats,
                               sband, srow0, vmask, block, chunk_blocks)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _group_argmin_variant_plain(g4, feats, band_of_block, block, reduction, precision,
                                chunk_px=4096):
    n_blocks = band_of_block.shape[0]
    f = feats.reshape(n_blocks, 4, block)
    n_read = _GROUPS_PER_TILE if reduction == "none" else G4_TILE
    out = torch.empty((n_blocks, 1, block), dtype=torch.int32, device=feats.device)
    chunk_blocks = max(1, chunk_px // block)  # j holds chunk_px x 8,192 f32 entries
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        g = g4[band_of_block[b0:b1].to(torch.int64)][..., :n_read, None]  # (nb, 4, 4, e, 1)
        fb = f[b0:b1, None, :, None, :]  # (nb, 1, 4, 1, block)
        if precision == "default":
            g, fb = _bf16(g), _bf16(fb)
        j = g[:, :, 0] * fb[:, :, 0] + g[:, :, 1] * fb[:, :, 1]  # (nb, tiles, e, block)
        j = j + g[:, :, 2] * fb[:, :, 2]
        j = j + g[:, :, 3] * fb[:, :, 3]
        if reduction in ("reshape", "static_slices"):
            rows = j.reshape(b1 - b0, G4_TILES, _GROUPS_PER_TILE, GROUP_SIZE, block).amin(3)
        elif reduction == "flat_min":
            rows = torch.full((b1 - b0, G4_TILES, _GROUPS_PER_TILE, block), float("inf"),
                              device=j.device)
            rows[:, :, 0] = j.amin(2)
        else:
            rows = j
        rows = rows.reshape(b1 - b0, _N_GROUPS, block)
        nan = torch.isnan(rows).any(1)
        best = torch.argmin(torch.where(torch.isnan(rows), float("inf"), rows), 1)
        out[b0:b1, 0] = torch.where(nan, _N_GROUPS - 1, best).to(torch.int32)
    return out


# ------------------------------------------------------------------ wrappers

def slab_forms(form, lut, u, v, kr, feats, sband, srow0, vmask, block=K.SLAB_BLOCK):
    """K5: the slab sweep in cost form ``form`` per (band, group) block.

    lut (I, Wp, P), u/v (Wp, P) and kr (Wp, P) (``expanded_uv`` only, else
    None) from :func:`build_form_arrays`; feats (n_blocks*block, 4) f32
    rows (s0_db, ma/2, mz/2, 1/dsig) for ``direct``, (s0_db * inv_dsig,
    ma/2, mz/2, 1) for the other two, NaN rows for padding; sband, srow0,
    vmask (n_blocks,) as for :func:`K.slab_refine`. Returns (n_blocks,
    block) i32 flat indices into the true (W, P) grid with K3's sentinels
    (``2**30`` for a NaN cost in the slab, ``((2**30 // P) & ~1) * P`` for
    no finite cost), 0 in all-padding blocks.
    """
    if form not in FORMS:
        raise ValueError(f"unknown slab cost form {form!r}; expected one of {FORMS}")
    if (kr is None) != (form != "expanded_uv"):
        raise ValueError(f"slab_forms: kr is {'needed' if kr is None else 'unused'} "
                         f"for form {form!r}")
    n_blocks = sband.shape[0]
    if feats.device.type == "cpu":
        return _slab_forms_plain(form, lut, u, v, kr, feats, sband, srow0, vmask, block)
    if feats.device.type != "cuda":
        raise ValueError(f"slab_forms: unsupported device {feats.device}")
    n_inc, wp_rows, n_phi = lut.shape
    i32 = [x.to(torch.int32) for x in (sband, srow0, vmask)]
    K._cuda_args(feats.device, {
        "lut": (lut, torch.float32, None),
        "u": (u, torch.float32, (wp_rows, n_phi)),
        "v": (v, torch.float32, (wp_rows, n_phi)),
        **({} if kr is None else {"kr": (kr, torch.float32, (wp_rows, n_phi))}),
        "feats": (feats, torch.float32, (n_blocks * block, 4)),
        "sband": (i32[0], torch.int32, None), "srow0": (i32[1], torch.int32, None),
        "vmask": (i32[2], torch.int32, None)})
    if feats.data_ptr() % 16 or not 0 < block <= 1024:
        raise ValueError("slab_forms: feats must be 16-byte aligned, block in (0, 1024]")
    K._in_range(i32[0], 0, n_inc, "sband")
    K._in_range(i32[1], 0, wp_rows - K.SLAB_ROWS + 1, "srow0")
    out = torch.empty((n_blocks, block), dtype=torch.int32, device=feats.device)
    lib = K._load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_slab_forms(
            FORMS.index(form), lut.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if kr is None else kr.data_ptr(), feats.data_ptr(), i32[0].data_ptr(),
            i32[1].data_ptr(), i32[2].data_ptr(), out.data_ptr(), n_blocks, block, wp_rows,
            n_phi, K.SLAB_ROWS, K._no_hit_flat(n_phi), stream)
    K._check(lib, rc, f"slab_forms[{form}]")
    _launches[f"slab_forms/{form}"] += 1
    return out


def group_argmin_variant(g4, feats, band_of_block, *, block, reduction, precision):
    """K6: the coarse group argmin in expanded form, one TPU variant.

    g4 (I, 4, 4, 2048) f32: per band, 4 tiles of a K = 4 operand over 2048
    entries; feats (n_blocks, 4, block) f32, the TPU kernel's layout;
    band_of_block (n_blocks,) band per block; ``block`` in
    :data:`VARIANT_BLOCKS`, ``reduction`` in :data:`REDUCTIONS`,
    ``precision`` in :data:`PRECISIONS` (``default`` rounds both operands
    to bf16 first). Returns (n_blocks, 1, block) i32: per pixel the first of
    the 32 group rows holding their minimum, 31 if any row is NaN.
    ``flat_min`` fills the 7 rows per tile that the TPU leaves undefined
    with +inf.
    """
    if block not in VARIANT_BLOCKS or reduction not in REDUCTIONS \
            or precision not in PRECISIONS:
        raise ValueError(f"unknown variant block={block!r}, reduction={reduction!r}, "
                         f"precision={precision!r}; expected block in {VARIANT_BLOCKS}, "
                         f"reduction in {REDUCTIONS}, precision in {PRECISIONS}")
    n_blocks = band_of_block.shape[0]
    if feats.device.type == "cpu":
        return _group_argmin_variant_plain(g4, feats, band_of_block, block, reduction,
                                           precision)
    if feats.device.type != "cuda":
        raise ValueError(f"group_argmin_variant: unsupported device {feats.device}")
    band = band_of_block.to(torch.int32)
    K._cuda_args(feats.device, {
        "g4": (g4, torch.float32, (g4.shape[0], G4_TILES, 4, G4_TILE)),
        "feats": (feats, torch.float32, (n_blocks, 4, block)),
        "band_of_block": (band, torch.int32, None)})
    K._in_range(band, 0, g4.shape[0], "band_of_block")
    out = torch.empty((n_blocks, 1, block), dtype=torch.int32, device=feats.device)
    lib = K._load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_group_argmin_variant(g4.data_ptr(), feats.data_ptr(), band.data_ptr(),
                                         out.data_ptr(), n_blocks, block,
                                         int(precision == "default"),
                                         _REDUCTION_CODE[reduction], stream)
    name = variant_name(block, reduction, precision)
    K._check(lib, rc, f"group_argmin_variant[{name}]")
    _launches[f"group_argmin_variant/{name}"] += 1
    return out
