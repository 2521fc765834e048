"""2-D stencils and resampling for the gradients pipeline (counterpart of
``xsarsea_tpu.ops.conv2d``).

The reference reaches native performance for these through OpenCV C++
(``cv2.Scharr`` gradients.py:612-613, ``cv2.resize INTER_AREA``
gradients.py:351-352) and scipy ``convolve2d`` (gradients.py:637-672). Here
every stencil is a sum of shifted slices of the padded image, taps in order,
and the resamplings are two matmuls against precomputed weight matrices.

Boundary conventions:

* scipy ``boundary='symm'``  -> edge-repeating symmetric pad (np 'symmetric')
* cv2 default BORDER_REFLECT_101 -> edge-excluding reflect (np 'reflect')

All smoothing kernels (B2, B4, B22, B42, Bx*) have exactly-representable
dyadic entries summing to exactly 1.0, so the reference's ones-normalization
convolutions (e.g. gradients.py:710-711) are exact no-ops and are omitted.

Every function works on the last two axes of its image, so a stack of images
goes through in one call, and takes ``device`` under the package's rule: a
tensor is computed where it lives, a numpy array on ``device`` (default
``"cuda"``, which raises on a host without a card). A tensor on the compute
device comes back.

TF32: on an H100 cuDNN convolutions run in TF32 by default and matmuls do
once a caller has set ``torch.set_float32_matmul_precision``, which costs
about 1e-3 relative on float32 data. No stencil here is a library
convolution, and the two resamplings run their matmuls with TF32 forbidden.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

from xsarsea_tpu_torch.utils import as_tensor, compute_device

__all__ = [
    "conv2d_same",
    "scharr",
    "B2_KERNEL",
    "B4_KERNEL",
    "smooth_b2",
    "r2_reduce",
    "local_mean",
    "coarsen2_mean",
    "zoom_bilinear",
    "resize_area",
]

# binomial smoothing kernels (gradients.py:678, 703-706, 737-744)
B2_KERNEL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64) / 16.0


def _conv_full(a, b):
    """2-D full convolution of small host kernels."""
    out = np.zeros((a.shape[0] + b.shape[0] - 1, a.shape[1] + b.shape[1] - 1))
    for i in range(b.shape[0]):
        for j in range(b.shape[1]):
            out[i:i + a.shape[0], j:j + a.shape[1]] += a * b[i, j]
    return out


B4_KERNEL = _conv_full(B2_KERNEL, B2_KERNEL)
B22_KERNEL = np.array(
    [[1, 0, 2, 0, 1], [0, 0, 0, 0, 0], [2, 0, 4, 0, 2],
     [0, 0, 0, 0, 0], [1, 0, 2, 0, 1]], dtype=np.float64) / 16.0
B42_KERNEL = _conv_full(B22_KERNEL, B22_KERNEL)

# Scharr correlation kernels (cv2.Scharr with dx=1 / dy=1)
SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], dtype=np.float64)
SCHARR_Y = SCHARR_X.T

_BOUNDARY_TO_PAD = {"symm": "symmetric", "reflect101": "reflect", "fill": "constant",
                    "wrap": "wrap"}


def _image(img, device):
    """``img`` as a tensor on the call's device."""
    return as_tensor(img, compute_device(device, img))


@lru_cache(maxsize=128)
def _pad_index(n, before, after, mode, device):
    """Positions of a padded axis, by numpy's rule for ``mode``.
    ``torch.nn.functional.pad`` has no symmetric mode and refuses a pad as
    wide as the image; numpy mirrors as often as it takes."""
    return torch.as_tensor(np.pad(np.arange(n), (before, after), mode=mode), device=device)


def _pad_axis(x, axis, before, after, mode, fill):
    """``x`` padded along ``axis`` (-2 or -1) with one of numpy's modes."""
    if before == 0 and after == 0:
        return x
    if mode == "constant":
        widths = (before, after) if axis == -1 else (0, 0, before, after)
        return torch.nn.functional.pad(x, widths, value=fill)
    return x.index_select(axis, _pad_index(x.shape[axis], before, after, mode, x.device))


@lru_cache(maxsize=64)
def _separate_kernel(kernel_bytes, shape):
    """Exact rank-1 factorization of a stencil, or None.

    Returns (col (kh,), row (kw,)) f64 vectors with ``outer(col, row)``
    EXACTLY equal to the kernel (bitwise in f64) — true for every kernel
    in this module (binomial products and Scharr, all dyadic). Kernels that
    do not factorize return None and take the full 2-D sum.
    """
    k = np.frombuffer(kernel_bytes, dtype=np.float64).reshape(shape)
    i0, j0 = np.unravel_index(np.argmax(np.abs(k)), k.shape)
    if k[i0, j0] == 0:
        return None
    row = k[i0, :] / k[i0, j0]
    col = k[:, j0]
    if not np.array_equal(np.outer(col, row), k):
        return None
    return col, row


def _conv1d_slices(x, taps, axis, mode, fill):
    """1-D 'same' convolution along ``axis`` (-2 or -1) as shifted slices.

    Each tap is one slice of the padded image times its weight, added in tap
    order: the order of the sum is fixed, on any device. Taps with weight
    exactly 0 (Scharr's center, the dilated B22/B42 lattices) are skipped.

    scipy 'same' anchor: pad k//2 BEFORE and (k-1)//2 after (verified
    against scipy.signal.convolve2d for odd and even kernel dims; the
    swapped split matches odd kernels only and shifts even ones by 1).
    """
    k = len(taps)
    xp = _pad_axis(x, axis, k // 2, (k - 1) // 2, mode, fill)
    n = x.shape[axis]
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        term = xp.narrow(axis, i, n) * w
        out = term if out is None else out + term
    return out


def _conv_valid(xp, kernel):
    """2-D valid cross-correlation of a padded image with the full kernel, as
    a sum of shifted slices, rows then columns, zero taps skipped. The kernel
    is cast to the image's dtype (an integer image takes an integer-valued
    kernel losslessly)."""
    kh, kw = kernel.shape
    h, w = xp.shape[-2] - kh + 1, xp.shape[-1] - kw + 1
    weights = torch.as_tensor(kernel).to(xp.dtype).tolist()
    out = None
    for i in range(kh):
        for j in range(kw):
            if weights[i][j] == 0:
                continue
            term = xp.narrow(-2, i, h).narrow(-1, j, w) * weights[i][j]
            out = term if out is None else out + term
    return torch.zeros_like(xp.narrow(-2, 0, h).narrow(-1, 0, w)) if out is None else out


def conv2d_same(img, kernel, boundary="symm", fillvalue=0.0, correlate=False, device="cuda"):
    """scipy.signal.convolve2d(mode='same') equivalent on the last two axes.

    True convolution (kernel flipped) unless ``correlate=True``; a complex
    image is convolved part by part.

    Separable kernels (every stencil in this pipeline: B2/B4/B22/B42
    binomials and Scharr) run as two shifted-slice 1-D passes, columns then
    rows. Padding one axis commutes exactly with convolving the other
    (mirrored columns are copies; a zero fill column convolves to zero), so
    boundary handling is bit-faithful to the fused 2-D pad for
    symm/reflect/wrap and for fill == 0.
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    if not correlate:
        kernel = kernel[::-1, ::-1]
    kernel = np.ascontiguousarray(kernel)
    kh, kw = kernel.shape
    factors = _separate_kernel(kernel.tobytes(), kernel.shape)
    mode = _BOUNDARY_TO_PAD[boundary]
    img = _image(img, device)
    inexact = img.is_floating_point() or img.is_complex()
    # the rank-1 factors of an integer-valued kernel can carry fractional
    # taps (e.g. [[1,2],[2,4]] -> row [1, 0.5]) that an integer image dtype
    # would truncate to 0: integer images take the full kernel
    separable = (factors is not None and not (mode == "constant" and fillvalue != 0.0)
                 and inexact)
    if separable:
        col, row = (tuple(float(w) for w in f) for f in factors)

        def run(x):
            y = _conv1d_slices(x, col, -2, mode, fillvalue)
            return _conv1d_slices(y, row, -1, mode, fillvalue)

    else:

        def run(x):  # see _conv1d_slices for the anchor rule
            xp = _pad_axis(x, -2, kh // 2, (kh - 1) // 2, mode, fillvalue)
            xp = _pad_axis(xp, -1, kw // 2, (kw - 1) // 2, mode, fillvalue)
            return _conv_valid(xp, kernel)

    if img.is_complex():
        return torch.complex(run(img.real), run(img.imag))
    return run(img)


def scharr(img, axis, device="cuda"):
    """cv2.Scharr equivalent (correlation, BORDER_REFLECT_101).

    axis=1 -> d/dx (sample direction), axis=0 -> d/dy (line direction),
    matching cv2.Scharr(img, CV_64F, 1, 0) / (0, 1) at gradients.py:612-613.
    """
    k = SCHARR_X if axis == 1 else SCHARR_Y
    return conv2d_same(img, k, boundary="reflect101", correlate=True, device=device)


def smooth_b2(img, device="cuda"):
    """B2 gaussian-like smoothing with symmetric boundary (gradients.py:675-686)."""
    return conv2d_same(img, B2_KERNEL, boundary="symm", device=device)


def coarsen2_mean(img, device="cuda"):
    """2x2 block mean with trailing trim (xr.coarsen boundary='trim').

    Row-pair add, then column-pair add, then one multiply: the summation tree
    ``(x00 + x10) + (x01 + x11)``, times 0.25, bit-identical to
    ``DimArray.coarsen_mean({"line": 2, "sample": 2})`` (pair means are exact
    scalings by a power of two).
    """
    img = _image(img, device)
    h = (img.shape[-2] // 2) * 2
    w = (img.shape[-1] // 2) * 2
    x = img[..., :h, :w]
    r = x[..., 0::2, :] + x[..., 1::2, :]
    return (r[..., 0::2] + r[..., 1::2]) * 0.25


def r2_reduce(img, device="cuda"):
    """Anti-moiré reduce-by-2: B4 pre-smooth, 2x2 trim-mean, B2 post-smooth.

    Faithful to the reference R2 (gradients.py:689-721); the ones-kernel
    normalizations there are exact no-ops (kernels sum to exactly 1.0).
    """
    x = conv2d_same(img, B4_KERNEL, boundary="symm", device=device)
    x = coarsen2_mean(x)
    return conv2d_same(x, B2_KERNEL, boundary="symm")


def local_mean(img, device="cuda"):
    """Local mean operator: B4 then B42 smoothing (gradients.py:724-755)."""
    x = conv2d_same(img, B4_KERNEL, boundary="symm", device=device)
    return conv2d_same(x, B42_KERNEL, boundary="symm")


@contextlib.contextmanager
def _full_precision_matmul():
    """Forbid TF32 in float32 matmuls for the block (about 1e-3 relative on
    float32 data otherwise, once a caller has allowed it)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _resample(img, weights, out_shape, device):
    """``W_r @ img @ W_c^T`` on the last two axes, in a float dtype: casting
    fractional weights to an integer image dtype would truncate them to 0/1
    and zero out the result."""
    img = _image(img, device)
    dt = torch.promote_types(img.dtype, torch.float32)
    wr = torch.as_tensor(weights(img.shape[-2], out_shape[0]), dtype=dt, device=img.device)
    wc = torch.as_tensor(weights(img.shape[-1], out_shape[1]), dtype=dt, device=img.device)
    with _full_precision_matmul():
        return torch.matmul(torch.matmul(wr, img.to(dt)), wc.T)


@lru_cache(maxsize=64)
def _zoom_weights(n_in, n_out):
    """Bilinear resampling weights matching scipy.ndimage.zoom(order=1).

    scipy's default grid convention maps output index i to input coordinate
    ``i * (n_in - 1) / (n_out - 1)`` (endpoints aligned)."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    if n_out == 1:
        w[0, 0] = 1.0
        return w
    x = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(x).astype(int), 0, n_in - 2)
    frac = x - i0
    w[np.arange(n_out), i0] = 1.0 - frac
    w[np.arange(n_out), i0 + 1] += frac
    return w


def zoom_bilinear(img, out_shape, device="cuda"):
    """scipy.ndimage.zoom(order=1) equivalent as two matmuls."""
    return _resample(img, _zoom_weights, out_shape, device)


@lru_cache(maxsize=64)
def _area_weights(n_in, n_out):
    """Fractional-overlap row weights for INTER_AREA shrink (n_out x n_in)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        a, b = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(a)), int(np.ceil(b))
        for j in range(j0, min(j1, n_in)):
            w[i, j] = min(b, j + 1) - max(a, j)
        w[i] /= w[i].sum()
    return w


def resize_area(img, out_shape, device="cuda"):
    """cv2.resize(..., INTER_AREA) equivalent for shrinking, as two matmuls.

    Exact fractional area averaging (what INTER_AREA computes when
    downscaling), expressed as W_r @ img @ W_c^T. Used by the multiscale
    resampler (gradients.py:336-362).
    """
    return _resample(img, _area_weights, out_shape, device)
