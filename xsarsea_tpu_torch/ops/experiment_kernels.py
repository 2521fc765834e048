"""The experiment kernels of ``scripts/``, their plain versions and operands.

* K5 :func:`slab_forms` replaces ``run_form`` (``scripts/bench_slab_forms.py``):
  K3's slab sweep in one of three cost forms, emitting K3's flat index.
  ``direct`` is K3's cost; ``prescaled`` folds ``inv_dsig`` into the LUT and
  the pixel's sigma0 beforehand; ``expanded_uv`` also expands the wind terms
  against a per-entry row ``kr = (u/2)^2 + (v/2)^2``. The two rewrites round
  differently, so near-ties can flip: the driver
  (``xsarsea_tpu_torch/scripts/bench_slab_forms.py``) counts the flips. Two
  loops (:data:`LOOPS`): ``shared``, the sweep K2 and K3 run, and
  ``thread``, the one-pixel-a-thread loop they ran before it, the baseline.
* K6 :func:`group_argmin_variant` replaces ``make_variant.run``
  (``scripts/bench_kernel_variants.py``): the TPU's coarse pass as a K = 4
  product ``g4[band, tile]^T . feats``, reduced to 32 group rows per pixel,
  then the first row holding the minimum, in the variants of matmul
  precision, group-min reduction and block size that the driver
  (``xsarsea_tpu_torch/scripts/bench_kernel_variants.py``) times. Two
  engines (:data:`ENGINES`): ``cuda_cores``, the product summed left to
  right in f32, bit-equal to its plain version; ``tensor_cores``, the
  product on mma.sync in bf16 (``default``) or in exact three-term bf16
  splits (``highest``, :func:`split3_bf16`), with g4 split once by
  :func:`split_g4`. Its sums are the tensor core's, so it is held to its
  plain version up to near-ties (:func:`tc_flips`).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/slab_forms.cu``, ``csrc/group_argmin_variants.cu``,
``csrc/group_argmin_variants_tc.cu``, built into the library of
:mod:`xsarsea_tpu_torch.ops.inversion_kernels`) or raises; on a CPU tensor
it runs the plain PyTorch version. Each wrapper counts its launches per
form or variant and per loop or engine (:func:`launch_counts`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.utils import spans

__all__ = [
    "ENGINES",
    "FORMS",
    "G4_TILES",
    "G4_TILE",
    "GROUP_SIZE",
    "LOOPS",
    "PRECISIONS",
    "REDUCTIONS",
    "VARIANT_BLOCKS",
    "build_form_arrays",
    "group_argmin_variant",
    "launch_counts",
    "reset_launch_counts",
    "slab_forms",
    "split3_bf16",
    "split_g4",
    "tc_flips",
    "variant_name",
]

FORMS = ("direct", "prescaled", "expanded_uv")
# K5's loops: the shared slab sweep of K2/K3, and the one-pixel-a-thread
# loop they ran before it (the experiment's baseline)
LOOPS = ("shared", "thread")

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
# K6's engines: the product on the FP32 pipe (the baseline), or on mma.sync
ENGINES = ("cuda_cores", "tensor_cores")
_M_TILE = 16  # entries per mma.sync tile (its M dimension)
# the tensor-core operand's 32-bit words a lane per 16-entry tile: m16n8k16's
# A fragment for the split (K = 48), m16n8k8's for bf16 (K = 8)
_TC_WORDS = {"highest": 4, "default": 2}
TIE_REL = 2.0 ** -20  # a tensor-core flip must lie within this share of S_p

_LAUNCH = "launch.experiment/"  # the launch counters' prefix among the port's counters


def _count(key):
    spans.count(_LAUNCH + key)


def reset_launch_counts():
    spans.reset(_LAUNCH)


def launch_counts():
    """Kernel launches since the last reset, per form (``slab_forms/<form>``
    on the shared loop, ``slab_forms_thread/<form>`` on the thread loop),
    variant (``group_argmin_variant/<variant_name>`` on CUDA cores,
    ``group_argmin_variant_tc/<variant_name>`` on tensor cores) and g4
    split (``split_g4/<precision>``); plain-version calls on the CPU do not
    count."""
    return spans.counters(_LAUNCH)


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


_TINY = float(np.finfo(np.float32).tiny)


def _sub_ftz(a, b):
    """f32 ``a - b`` with subnormal operands and result flushed to zero of
    their sign, as XLA's CPU backend and the TPU subtract (PTX
    ``sub.rn.ftz.f32`` on the card)."""
    def ftz(x):
        return torch.where(x.abs() < _TINY, x * 0.0, x)
    return ftz(ftz(a) - ftz(b))


def split3_bf16(x):
    """The three-term bf16 split of f32 ``x`` (``_split3_bf16`` at
    ``xsarsea_tpu/ops/pallas_inversion.py:385``): ``(x0, x1, x2)`` bf16 with
    ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ``x2 = bf16((x - x0) - x1)``,
    the residuals flushed to zero where subnormal as the JAX package's
    backends flush them, so that ``x == x0 + x1 + x2`` for every f32 ``x``
    whose residuals are normal (every ``|x| >= 2**-102``)."""
    x0 = x.to(torch.bfloat16)
    r1 = _sub_ftz(x, x0.to(torch.float32))
    x1 = r1.to(torch.bfloat16)
    return x0, x1, _sub_ftz(r1, x1.to(torch.float32)).to(torch.bfloat16)


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products without TF32 on the card, whatever the caller set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _variant_costs(g, fb, precision, engine):
    """The K = 4 products of a chunk: g (nb, 4 tiles, 4, e) and fb (nb, 4,
    block) -> j (nb, tiles, e, block) f32. ``cuda_cores``, and
    ``tensor_cores`` at ``default`` (whose products of bf16 values are exact
    in f32): the four products summed left to right. ``tensor_cores`` at
    ``highest``: the nine cross products of both operands' three-term splits
    per channel, 36 exact products summed in f32 by one matmul."""
    if engine == "tensor_cores" and precision == "highest":
        gs = torch.stack([t.to(torch.float32) for t in split3_bf16(g)], 2)  # (nb, t, sa, 4, e)
        fs = torch.stack([t.to(torch.float32) for t in split3_bf16(fb)], 1)  # (nb, sb, 4, blk)
        nb, n_t, _, _, n_e = gs.shape
        a = gs[:, :, :, None].expand(-1, -1, -1, 3, -1, -1)  # (nb, t, sa, sb, 4, e)
        a = a.reshape(nb, n_t, 36, n_e).transpose(2, 3)  # (nb, t, e, 36)
        bm = fs[:, None].expand(-1, 3, -1, -1, -1).reshape(nb, 1, 36, -1)  # (nb, 1, 36, blk)
        with _full_f32_matmul():
            return torch.matmul(a, bm)
    g, fb = g[..., None], fb[:, None, :, None, :]  # (nb, t, 4, e, 1), (nb, 1, 4, 1, block)
    if precision == "default":
        g, fb = _bf16(g), _bf16(fb)
    j = g[:, :, 0] * fb[:, :, 0] + g[:, :, 1] * fb[:, :, 1]  # (nb, tiles, e, block)
    j = j + g[:, :, 2] * fb[:, :, 2]
    return j + g[:, :, 3] * fb[:, :, 3]


def _variant_rows(j, reduction):
    """The variant's 32 scratch rows (nb, 32, block) from the costs j (nb,
    tiles, e, block) of the entries it reads."""
    nb, block = j.shape[0], j.shape[-1]
    if reduction in ("reshape", "static_slices"):
        rows = j.reshape(nb, G4_TILES, _GROUPS_PER_TILE, GROUP_SIZE, block).amin(3)
    elif reduction == "flat_min":
        rows = torch.full((nb, G4_TILES, _GROUPS_PER_TILE, block), float("inf"),
                          dtype=j.dtype, device=j.device)
        rows[:, :, 0] = j.amin(2)
    else:
        rows = j
    return rows.reshape(nb, _N_GROUPS, block)


def _group_argmin_variant_plain(g4, feats, band_of_block, block, reduction, precision,
                                chunk_px=4096, engine="cuda_cores"):
    n_blocks = band_of_block.shape[0]
    f = feats.reshape(n_blocks, 4, block)
    n_read = _GROUPS_PER_TILE if reduction == "none" else G4_TILE
    out = torch.empty((n_blocks, 1, block), dtype=torch.int32, device=feats.device)
    chunk_blocks = max(1, chunk_px // block)  # j holds chunk_px x 8,192 f32 entries
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        g = g4[band_of_block[b0:b1].to(torch.int64)][..., :n_read]  # (nb, 4, 4, e)
        rows = _variant_rows(_variant_costs(g, f[b0:b1], precision, engine), reduction)
        nan = torch.isnan(rows).any(1)
        best = torch.argmin(torch.where(torch.isnan(rows), float("inf"), rows), 1)
        out[b0:b1, 0] = torch.where(nan, _N_GROUPS - 1, best).to(torch.int32)
    return out


def _split_g4_plain(g4, precision):
    """The tensor-core operand of :func:`split_g4`, built with torch ops."""
    n_bands = g4.shape[0]
    words = _TC_WORDS[precision]
    lane = torch.arange(32, device=g4.device)
    w = torch.arange(words, device=g4.device)
    row = (lane[:, None] >> 2) + 8 * (w[None, :] & 1)  # (32, words)
    k0 = 2 * (lane[:, None] & 3) + 8 * (w[None, :] >> 1)
    tiles = g4.reshape(n_bands, G4_TILES, 4, G4_TILE // _M_TILE, _M_TILE)  # (I, t, c, mt, r)
    if precision == "highest":  # A's columns: split term k // 4 of channel k % 4, k < 12
        terms = torch.stack(split3_bf16(tiles), 2)  # (I, t, s, c, mt, r) bf16
        cols = terms.reshape(n_bands, G4_TILES, 12, G4_TILE // _M_TILE, _M_TILE)
    else:  # channel k, k < 4
        cols = tiles.to(torch.bfloat16)
    n_k = cols.shape[2]
    cols = torch.cat([cols, torch.zeros_like(cols[:, :, :1])], 2)  # column n_k: zero
    cols = cols.permute(0, 1, 3, 2, 4)  # (I, t, mt, k, r)
    halves = []
    for h in range(2):
        k = torch.clamp(k0 + h, max=n_k)
        bits = cols[:, :, :, k, row].view(torch.int16).to(torch.int32)  # (I, t, mt, 32, words)
        halves.append(bits & 0xFFFF)
    return (halves[0] | (halves[1] << 16)).contiguous()


# ------------------------------------------------------------------ wrappers

def slab_forms(form, lut, u, v, kr, feats, sband, srow0, vmask, block=K.SLAB_BLOCK, *,
               loop="shared"):
    """K5: the slab sweep in cost form ``form`` per (band, group) block.

    lut (I, Wp, P), u/v (Wp, P) and kr (Wp, P) (``expanded_uv`` only, else
    None) from :func:`build_form_arrays`; feats (n_blocks*block, 4) f32
    rows (s0_db, ma/2, mz/2, 1/dsig) for ``direct``, (s0_db * inv_dsig,
    ma/2, mz/2, 1) for the other two, NaN rows for padding; sband, srow0,
    vmask (n_blocks,) as for :func:`K.slab_refine`. Returns (n_blocks,
    block) i32 flat indices into the true (W, P) grid with K3's sentinels
    (``2**30`` for a NaN cost in the slab, ``((2**30 // P) & ~1) * P`` for
    no finite cost), 0 in all-padding blocks. ``loop`` (:data:`LOOPS`):
    ``shared``, K3's sweep in the form (blocks of ``K.SLAB_BLOCK`` pixels;
    its direct form is K3), or ``thread``, the one-pixel-a-thread baseline
    (any block up to 1024). Both loops compute the same function: one plain
    version serves both.
    """
    if form not in FORMS:
        raise ValueError(f"unknown slab cost form {form!r}; expected one of {FORMS}")
    if loop not in LOOPS:
        raise ValueError(f"unknown slab loop {loop!r}; expected one of {LOOPS}")
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
    if loop == "shared":
        if block != K.SLAB_BLOCK:
            raise ValueError(f"slab_forms: the shared loop takes blocks of {K.SLAB_BLOCK} pixels")
        K._check_smem(K.slab_smem_bytes(n_phi, K.SLAB_ROWS, planes=3 + (kr is not None)),
                      "slab_forms")
    else:
        K._check_smem(4 * K.SLAB_ROWS * n_phi * (1 + (kr is not None)), "slab_forms")
    K._in_range(i32[0], 0, n_inc, "sband")
    K._in_range(i32[1], 0, wp_rows - K.SLAB_ROWS + 1, "srow0")
    out = torch.empty((n_blocks, block), dtype=torch.int32, device=feats.device)
    lib = K._load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_slab_forms(
            FORMS.index(form), LOOPS.index(loop), lut.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if kr is None else kr.data_ptr(), feats.data_ptr(), i32[0].data_ptr(),
            i32[1].data_ptr(), i32[2].data_ptr(), out.data_ptr(), n_blocks, block, wp_rows,
            n_phi, K.SLAB_ROWS, K._no_hit_flat(n_phi), stream)
    K._check(lib, rc, f"slab_forms[{form}, {loop}]")
    _count(f"slab_forms/{form}" if loop == "shared" else f"slab_forms_thread/{form}")
    return out


def split_g4(g4, precision):
    """The tensor-core engine's g4 operand: g4 (I, 4, 4, 2048) f32 split
    into mma.sync A fragments, (I, 4 tiles, 128 16-entry tiles, 32 lanes,
    words) int32 holding bf16 pairs: for ``highest`` (4 words) each entry's
    row is the three-term split of its four channels (:func:`split3_bf16`)
    and four zeros, for ``default`` (2 words) its channels rounded to bf16
    and four zeros. A prep kernel on a CUDA tensor (one launch, counted as
    ``split_g4/<precision>``), torch ops on a CPU one: the same bits."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if g4.device.type == "cpu":
        return _split_g4_plain(g4, precision)
    if g4.device.type != "cuda":
        raise ValueError(f"split_g4: unsupported device {g4.device}")
    n_bands = g4.shape[0]
    K._cuda_args(g4.device, {"g4": (g4, torch.float32, (n_bands, G4_TILES, 4, G4_TILE))})
    out = torch.empty((n_bands, G4_TILES, G4_TILE // _M_TILE, 32, _TC_WORDS[precision]),
                      dtype=torch.int32, device=g4.device)
    lib = K._load()
    with torch.cuda.device(g4.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_split_g4(g4.data_ptr(), out.data_ptr(), n_bands,
                             int(precision == "highest"), stream)
    K._check(lib, rc, f"split_g4[{precision}]")
    _count(f"split_g4/{precision}")
    return out


def group_argmin_variant(g4, feats, band_of_block, *, block, reduction, precision,
                         engine="cuda_cores", g4_split=None):
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

    ``engine`` (:data:`ENGINES`): ``cuda_cores`` sums the four products
    left to right in f32; ``tensor_cores`` computes the product on mma.sync,
    at ``highest`` as the nine cross products of exact three-term bf16
    splits. Its sums are the tensor core's: it may differ from its plain
    version (which sums the same products in f32) at near-ties
    (:func:`tc_flips`). ``g4_split``: :func:`split_g4` of ``g4`` at this
    precision, made once and passed to every call; without it the wrapper
    splits g4 itself on each call. The plain versions ignore it.
    """
    if block not in VARIANT_BLOCKS or reduction not in REDUCTIONS \
            or precision not in PRECISIONS:
        raise ValueError(f"unknown variant block={block!r}, reduction={reduction!r}, "
                         f"precision={precision!r}; expected block in {VARIANT_BLOCKS}, "
                         f"reduction in {REDUCTIONS}, precision in {PRECISIONS}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    n_blocks = band_of_block.shape[0]
    if feats.device.type == "cpu":
        return _group_argmin_variant_plain(g4, feats, band_of_block, block, reduction,
                                           precision, engine=engine)
    if feats.device.type != "cuda":
        raise ValueError(f"group_argmin_variant: unsupported device {feats.device}")
    band = band_of_block.to(torch.int32)
    n_bands = g4.shape[0]
    K._cuda_args(feats.device, {
        "g4": (g4, torch.float32, (n_bands, G4_TILES, 4, G4_TILE)),
        "feats": (feats, torch.float32, (n_blocks, 4, block)),
        "band_of_block": (band, torch.int32, None)})
    K._in_range(band, 0, n_bands, "band_of_block")
    out = torch.empty((n_blocks, 1, block), dtype=torch.int32, device=feats.device)
    name = variant_name(block, reduction, precision)
    if engine == "tensor_cores":
        if g4_split is None:
            g4_split = split_g4(g4, precision)
        K._cuda_args(feats.device, {"g4_split": (g4_split, torch.int32, (
            n_bands, G4_TILES, G4_TILE // _M_TILE, 32, _TC_WORDS[precision]))})
        if g4_split.data_ptr() % 16:
            raise ValueError("group_argmin_variant: g4_split must be 16-byte aligned")
    lib = K._load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        if engine == "tensor_cores":
            rc = lib.xs_group_argmin_variant_tc(
                g4_split.data_ptr(), feats.data_ptr(), band.data_ptr(), out.data_ptr(),
                n_blocks, block, int(precision == "highest"), _REDUCTION_CODE[reduction],
                stream)
        else:
            rc = lib.xs_group_argmin_variant(g4.data_ptr(), feats.data_ptr(), band.data_ptr(),
                                             out.data_ptr(), n_blocks, block,
                                             int(precision == "default"),
                                             _REDUCTION_CODE[reduction], stream)
    K._check(lib, rc, f"group_argmin_variant[{name}, {engine}]")
    key = "group_argmin_variant" if engine == "cuda_cores" else "group_argmin_variant_tc"
    _count(f"{key}/{name}")
    return out


def tc_flips(g4, feats, band_of_block, got, ref, *, block, reduction, precision,
             chunk_px=256):
    """The tensor-core engine's gate: where its groups ``got`` differ from
    the plain version's ``ref`` (both (n_blocks, 1, block)), whether each
    differing pixel is a near-tie. In float64 from the operands the engine
    multiplies (bf16-rounded for ``default``, the sum of the three split
    terms for ``highest``), the two candidate rows' values must lie within
    :data:`TIE_REL` ``* S_p``, ``S_p = max_e sum_k |g_k[e] f_k[p]|`` over
    the entries the variant reads. Returns ``{"differ", "near_tie",
    "not_near_tie", "worst"}``, worst the largest ``|dJ| / S_p`` met."""
    n_blocks = band_of_block.shape[0]
    n_read = _GROUPS_PER_TILE if reduction == "none" else G4_TILE
    diff = torch.nonzero((got != ref).reshape(-1))[:, 0]
    report = {"differ": int(diff.numel()), "near_tie": 0, "not_near_tie": 0, "worst": 0.0}

    def operand(x):
        if precision == "default":
            return _bf16(x).double()
        return sum(t.double() for t in split3_bf16(x))

    f = feats.reshape(n_blocks, 4, block)
    for i0 in range(0, diff.numel(), chunk_px):
        px = diff[i0:i0 + chunk_px]
        b, p = px // block, px % block
        g = operand(g4[band_of_block[b].to(torch.int64)][..., :n_read])  # (n, t, 4, e)
        fp = operand(f[b, :, p])  # (n, 4)
        j = (g * fp[:, None, :, None]).sum(2)  # (n, t, e)
        s_p = (g * fp[:, None, :, None]).abs().sum(2).amax((1, 2))
        rows = _variant_rows(j[..., None], reduction)[..., 0]  # (n, 32)
        r_got = got.reshape(-1)[px].to(torch.int64)
        r_ref = ref.reshape(-1)[px].to(torch.int64)
        dj = (rows.gather(1, r_got[:, None]) - rows.gather(1, r_ref[:, None]))[:, 0].abs()
        rel = dj / s_p
        near = rel <= TIE_REL  # NaN (a NaN row) is no near-tie
        report["near_tie"] += int(near.sum())
        report["not_near_tie"] += int((~near).sum())
        report["worst"] = max(report["worst"], float(torch.nan_to_num(rel, nan=np.inf).max()))
    return report
