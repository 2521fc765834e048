"""The fused inversion's two kernels, their plain versions and operands.

Counterpart of ``xsarsea_tpu/ops/pallas_inversion.py:382-1106``.

* K1 :func:`group_argmin` replaces ``copol_group_argmin_pallas``: per
  256-pixel block sharing one incidence band, the direct-form cost over a
  coarse (~0.8 m/s x 4 deg) grid, the minimum per wind-speed group
  (``WGROUP`` LUT rows) and the first-minimum group per pixel.
* K2 :func:`slab_refine_fused` replaces ``slab_refine_fused_pallas``: per
  128-pixel block sharing one (band, group), the direct-form cost over a
  ``SLAB_ROWS`` x all-phi LUT slab with numpy's first-minimum rule in
  (wspd-major, phi-minor) order, the decode of the winner to (wspd, phi)
  and the crosspol 1-D argmin over the band's crosspol row.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/*.cu``, built with nvcc for ``sm_90a`` at first use and bound with
ctypes) or raises; on a CPU tensor it runs the plain PyTorch version, which
keeps the kernel's per-element op order as separate ops. Each wrapper
counts its kernel launches (:func:`launch_counts`).

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
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from xsarsea_tpu_torch.ops.bucketing import DEFAULT_BLOCK as GROUP_BLOCK

__all__ = [
    "GROUP_BLOCK",
    "KERNELS",
    "SLAB_BLOCK",
    "SLAB_MARGIN",
    "SLAB_ROWS",
    "WGROUP",
    "build_coarse_arrays",
    "build_crosspol_arrays",
    "build_decode_arrays",
    "build_direct_arrays",
    "build_kernels",
    "group_argmin",
    "launch_counts",
    "reset_launch_counts",
    "slab_refine_fused",
]

WGROUP = 16  # wspd rows per group: K1's output unit, K2's bucketing unit
SLAB_MARGIN = 16  # refine window half-width in wspd rows around the group
SLAB_ROWS = WGROUP + 2 * SLAB_MARGIN  # 48 rows: [16g-16, 16g+32)
SLAB_BLOCK = 128  # pixels per K2 block (one (band, group) each)
_PAD_LUT = 1e19  # padded LUT rows: cost overflows to +inf, never chosen

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("group_argmin.cu", "slab_refine_fused.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    (their cost overflows to +inf), so every 48-row slab start
    ``clip(16g - 16, 0, Wp - 48)`` reads real or padding rows only. u and v
    are stored halved: ``u/2 - ma/2`` rounds exactly as ``(u - ma)/2``.
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


def _group_argmin_plain(lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                        block, chunk_blocks=16):
    n_blocks = band_of_block.shape[0]
    inf = float("inf")
    f = feats.reshape(n_blocks, block, 4)
    # blocks of NaN (padding) rows have no finite cost: their answer is known
    out = torch.full((n_blocks, block), n_groups - 1, dtype=torch.int32, device=feats.device)
    live = torch.nonzero(~torch.isnan(f).all(dim=2).all(dim=1))[:, 0]
    rg = row_group.to(torch.int64)
    for c0 in range(0, live.shape[0], chunk_blocks):
        sel = live[c0:c0 + chunk_blocks]
        fb = f[sel][:, :, :, None, None]  # (nb, block, 4, 1, 1)
        j = _cost(lut_c[band_of_block[sel].to(torch.int64)][:, None], u_half, v_half,
                  fb[:, :, 0], fb[:, :, 1], fb[:, :, 2], fb[:, :, 3])  # (nb, block, R, C)
        rowmin = torch.where(torch.isnan(j), inf, j).amin(-1)  # NaN entries never win
        gmin = torch.full(rowmin.shape[:-1] + (n_groups,), inf, dtype=j.dtype, device=j.device)
        gmin.scatter_reduce_(-1, rg.expand_as(rowmin), rowmin, "amin")
        best = torch.argmin(gmin, -1)  # first minimum: lowest tied group
        found = torch.gather(gmin, -1, best[..., None])[..., 0] < inf
        out[sel] = torch.where(found, best, n_groups - 1).to(torch.int32)
    return out


def _slab_refine_fused_plain(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats,
                             sband, srow0, vmask, has_cr, block, chunk_blocks=16):
    n_blocks = sband.shape[0]
    n_phi = lut_pad.shape[2]
    dev = feats.device
    inf = float("inf")
    f = feats.reshape(n_blocks, block, 8)
    out = torch.zeros((n_blocks, 4, block), dtype=torch.float32, device=dev)
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        sel = torch.nonzero(vmask[b0:b1] != 0)[:, 0] + b0  # all-padding blocks stay 0
        if sel.numel() == 0:
            continue
        band = sband[sel].to(torch.int64)
        r0 = srow0[sel].to(torch.int64)
        rows = r0[:, None] + torch.arange(SLAB_ROWS, device=dev)  # (nb, SLAB_ROWS)
        fb = f[sel]  # (nb, block, 8)
        fe = fb[:, :, :, None, None]
        j = _cost(lut_pad[band[:, None], rows][:, None], u_half[rows][:, None],
                  v_half[rows][:, None], fe[:, :, 0], fe[:, :, 1], fe[:, :, 2], fe[:, :, 3])
        j = j.reshape(j.shape[0], block, SLAB_ROWS * n_phi)
        # a NaN anywhere poisons the pixel (the reference's NaN-propagating
        # min); otherwise the first strict minimum in row-major order
        poisoned = torch.isnan(j).any(-1)
        jc = torch.where(torch.isnan(j), inf, j)
        flat = torch.argmin(jc, -1)
        hit = (torch.gather(jc, -1, flat[..., None])[..., 0] < inf) & ~poisoned
        row = r0[:, None] + torch.div(flat, n_phi, rounding_mode="floor")
        col = torch.where(poisoned, 0, flat % n_phi)
        wspd_co = torch.where(hit, w_pad[row], 0.0)
        phi = torch.where(poisoned, 0.0, co_phir[col])
        out[sel, 0] = wspd_co
        out[sel, 1] = phi
        if has_cr:
            s0 = fb[:, :, 0]
            has_co = torch.where(torch.isnan(s0), 0.0, 1.0)[..., None]
            wco2 = torch.where(hit, w_pad[row] * 0.5, 0.0)[..., None] * has_co
            d = (cr_lut[band][:, None] - fb[:, :, 4, None]) / fb[:, :, 5, None]
            jcr = _sq(d) + _sq(cr_whalf - wco2) * has_co
            poisoned_cr = torch.isnan(jcr).any(-1)
            best = torch.argmin(torch.where(torch.isnan(jcr), inf, jcr), -1)
            out[sel, 2] = torch.where(poisoned_cr, 0.0, cr_whalf[best] + cr_whalf[best])
    return out


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


def build_kernels():
    """Compile ``csrc/*.cu`` into one shared library (once per source
    content, flags and nvcc version) and return its path. A failed build
    raises."""
    global build_log
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout
    h = hashlib.sha256((" ".join(_NVCC_FLAGS) + version).encode())
    for path in sorted(_CSRC.iterdir()):
        h.update(path.name.encode() + path.read_bytes())
    build_dir = _build_dir()
    lib = build_dir / f"libxsarsea_inversion_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.xs_group_argmin.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.xs_group_argmin.restype = i
            lib.xs_slab_refine_fused.argtypes = [p] * 12 + [i] * 7 + [p]
            lib.xs_slab_refine_fused.restype = i
            lib.xs_error_string.argtypes = [i]
            lib.xs_error_string.restype = ctypes.c_char_p
            _lib = lib
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


def _in_range(t, lo, hi, name):
    """Indices the kernel dereferences must lie in [lo, hi) (one sync)."""
    if t.numel():
        mn, mx = (int(x) for x in torch.aminmax(t))
        if mn < lo or mx >= hi:
            raise ValueError(f"{name} values [{mn}, {mx}] outside [{lo}, {hi})")


# ------------------------------------------------------------------ wrappers

def group_argmin(lut_c, u_half, v_half, row_group, feats, band_of_block, n_groups,
                 block=GROUP_BLOCK):
    """K1: first-minimum wspd group per pixel over the coarse grid.

    lut_c (I, R, C), u_half/v_half (R, C) f32 and row_group (R,) i32 come
    from :func:`build_coarse_arrays`; feats (n_blocks*block, 4) f32 rows
    (s0_db, ma/2, mz/2, 1/dsig), NaN rows for padding slots;
    band_of_block (n_blocks,) band per block. Returns (n_blocks, block)
    i32; pixels with no finite cost get ``n_groups - 1``.
    """
    n_blocks = band_of_block.shape[0]
    if feats.device.type == "cpu":
        return _group_argmin_plain(lut_c, u_half, v_half, row_group, feats, band_of_block,
                                   n_groups, block)
    if feats.device.type != "cuda":
        raise ValueError(f"group_argmin: unsupported device {feats.device}")
    n_rows, n_cols = u_half.shape
    band = band_of_block.to(torch.int32)
    _cuda_args(feats.device, {
        "lut_c": (lut_c, torch.float32, (lut_c.shape[0], n_rows, n_cols)),
        "u_half": (u_half, torch.float32, None),
        "v_half": (v_half, torch.float32, (n_rows, n_cols)),
        "row_group": (row_group, torch.int32, (n_rows,)),
        "feats": (feats, torch.float32, (n_blocks * block, 4)),
        "band_of_block": (band, torch.int32, None)})
    if feats.data_ptr() % 16 or not 0 < block <= 1024:
        raise ValueError("group_argmin: feats must be 16-byte aligned, block in (0, 1024]")
    _in_range(band, 0, lut_c.shape[0], "band_of_block")
    _in_range(row_group, 0, n_groups, "row_group")
    out = torch.empty((n_blocks, block), dtype=torch.int32, device=feats.device)
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_group_argmin(
            lut_c.data_ptr(), u_half.data_ptr(), v_half.data_ptr(), row_group.data_ptr(),
            feats.data_ptr(), band.data_ptr(), out.data_ptr(),
            n_blocks, block, n_rows, n_cols, n_groups, stream)
    _check(lib, rc, "group_argmin")
    _launches["group_argmin"] += 1
    return out


def slab_refine_fused(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats, sband,
                      srow0, vmask, has_cr=True, block=SLAB_BLOCK):
    """K2: slab refine + decode + crosspol argmin per (band, group) block.

    lut_pad (I, Wp, P), u_half/v_half (Wp, P) from
    :func:`build_direct_arrays`; w_pad (Wp,) wspd per row; co_phir (P,)
    phi in radians; cr_lut (I, Wc), cr_whalf (Wc,) from
    :func:`build_crosspol_arrays` (ignored with ``has_cr=False``); feats
    (n_blocks*block, 8) f32 rows (s0_db, ma/2, mz/2, 1/dsig, s0_cr_db,
    dsig_cr, 0, 0), NaN rows for padding; sband, srow0, vmask (n_blocks,):
    LUT band, first of the ``SLAB_ROWS`` slab rows and a 0 for all-padding
    blocks (their output
    is 0). Returns (n_blocks, 4, block) f32 rows (wspd_co, phi, wspd_cr, 0).
    A pixel whose slab costs hold a NaN gets (0, 0); its crosspol cost
    likewise gives 0.
    """
    n_blocks = sband.shape[0]
    if feats.device.type == "cpu":
        return _slab_refine_fused_plain(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut,
                                        cr_whalf, feats, sband, srow0, vmask, has_cr, block)
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
        "feats": (feats, torch.float32, (n_blocks * block, 8)),
        "sband": (i32[0], torch.int32, None), "srow0": (i32[1], torch.int32, None),
        "vmask": (i32[2], torch.int32, None)})
    if not 0 < block <= 1024:
        raise ValueError("slab_refine_fused: block must be in (0, 1024]")
    _in_range(i32[0], 0, n_inc, "sband")
    _in_range(i32[1], 0, wp_rows - SLAB_ROWS + 1, "srow0")
    out = torch.empty((n_blocks, 4, block), dtype=torch.float32, device=feats.device)
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.xs_slab_refine_fused(
            lut_pad.data_ptr(), u_half.data_ptr(), v_half.data_ptr(), w_pad.data_ptr(),
            co_phir.data_ptr(), cr_lut.data_ptr(), cr_whalf.data_ptr(), feats.data_ptr(),
            i32[0].data_ptr(), i32[1].data_ptr(), i32[2].data_ptr(), out.data_ptr(),
            n_blocks, block, wp_rows, n_phi, SLAB_ROWS, n_cr, int(bool(has_cr)), stream)
    _check(lib, rc, "slab_refine_fused")
    _launches["slab_refine_fused"] += 1
    return out


KERNELS = {"group_argmin": group_argmin, "slab_refine_fused": slab_refine_fused}
_launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0


def launch_counts():
    """Kernel launches per wrapper since the last reset (plain-version
    calls on the CPU do not count)."""
    return dict(_launches)
