"""dsig weighting schemes and NESZ flattening (counterpart of
``xsarsea_tpu.windspeed.dsig``, the reference's ``windspeed/utils.py``).

``get_dsig`` / ``get_dsig_wspd`` are elementwise formulas; ``nesz_flattening``
replaces the reference's per-row ``np.polyfit`` loop (utils.py:138-163) with
a closed-form weighted line fit over all rows at once, in two steps that
``invert_from_model`` also runs when it weights the crosspol channel from its
raw NESZ: :func:`nesz_row_fit` (the column means and every row's line, once a
scene) and :func:`nesz_expand` (the lines over any flat range of the scene).

Each takes a ``device`` keyword (default ``"cuda"``): numpy inputs are
copied there, computed and copied back as numpy; a tensor input is computed
on the device it lives on and a tensor comes back. The dtype of the inputs is
kept: the line fit's ``sw * sxx - sx * sx`` cancels in float32 (about 1e-5
relative on the flattened NESZ for incidences of 18-47 degrees), so pass
float64 where that matters.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.interop import xarray_io
from xsarsea_tpu_torch.utils import as_tensor, compute_device, to_host

__all__ = ["get_dsig", "get_dsig_wspd", "nesz_flattening", "nesz_row_fit", "nesz_expand",
           "DSIG_NAMES"]

# sigmoid-blend constants tuned per satellite (reference utils.py:26-42)
_DSIG_WSPD_PARAMS = {
    "dsig_wspd_rs2_v3": (-0.4908643753212401, 16.763199934792965,
                         1.3891445172991084, 20.616914824394343),
    "dsig_wspd_s1_ew_rec_v3": (-0.5858970325653666, 16.50039320910609,
                               1.1032031322520397, 7.434663633997121),
    "dsig_wspd_rcm_v3": (-0.7920301376936547, 15.8288289109038,
                         0.24040294696606557, 0.2538177092195224),
}


def _data(x):
    return x.data if isinstance(x, DimArray) else x


def _tensors(device, *arrays):
    """The arrays as tensors on the call's device (``compute_device``)."""
    device = compute_device(device, *arrays)
    return [as_tensor(a, device) for a in arrays]


def _wrap_like(template, out):
    """``out`` in the kind of ``template``: numpy for numpy, a tensor for a
    tensor, a DimArray (attrs dropped) around either for a DimArray."""
    if not isinstance(_data(template), torch.Tensor):
        out = to_host(out)
    if isinstance(template, DimArray):
        res = template.copy(data=out)
        res.attrs = {}
        return res
    return out


@xarray_io
def get_dsig_wspd(name, U_crosspol, SNR_cr, Umax=30.0, device="cuda"):
    """Wind-speed-dependent dsig blend alpha (reference utils.py:18-44)."""
    try:
        b, c0_base, gamma, k = _DSIG_WSPD_PARAMS[name]
    except KeyError:
        raise ValueError(f"unknown dsig_wspd name '{name}'") from None
    u, snr = _tensors(device, _data(U_crosspol), _data(SNR_cr))
    c0 = c0_base - gamma * snr
    alpha_core = 1.0 / (1.0 + torch.exp(-b * (u - c0)))
    drop = 1.0 / (1.0 + torch.exp((u - Umax) * k))
    return _wrap_like(U_crosspol, torch.clip(alpha_core * drop, 0.0, 1.0))


DSIG_NAMES = ("gmf_s1_v2", "gmf_rs2_v2", "sarwing_lut_cmodms1ahw", "nc_lut_cmodms1ahw")


def check_dsig_name(name):
    """Raise for a dsig scheme that :func:`get_dsig` does not know."""
    if name not in DSIG_NAMES:
        raise ValueError(
            "dsig names other than 'gmf_s1_v2', 'gmf_rs2_v2', "
            "'sarwing_lut_cmodms1ahw' or 'nc_lut_cmodms1ahw' are not handled. "
            "You can compute your own dsig_cr.")


def dsig_formula(name, inc, sigma0_cr, nesz_cr):
    """The named scheme's ``dsig_cr`` on tensors (utils.py:47-91), in their
    dtype; ``name`` is one of :data:`DSIG_NAMES`."""
    if name == "gmf_s1_v2":
        c0, c1, d0, d1 = 1.57952257, 25.61843791, 1.46852088, 1.4058646
        c = d0 + d1 / (1.0 + torch.exp(-c0 * (inc - c1)))
        return 1.0 / torch.sqrt((sigma0_cr / nesz_cr) ** c)
    if name == "gmf_rs2_v2":
        return 1.0 / torch.sqrt((sigma0_cr / nesz_cr) ** 8.0)
    return (1.25 / (sigma0_cr / nesz_cr)) ** 4.0


@xarray_io
def get_dsig(name, inc, sigma0_cr, nesz_cr, device="cuda"):
    """Named dsig_cr weighting for the crosspol cost term (utils.py:47-91)."""
    check_dsig_name(name)
    inc_d, s0, nesz = _tensors(device, _data(inc), _data(sigma0_cr), _data(nesz_cr))
    return _wrap_like(sigma0_cr, dsig_formula(name, inc_d, s0, nesz))


def _row_fit(noise, inc_1d, col_mean):
    """Order-1 fit of noise_dB against incidence for every row at once:
    ``(slope, intercept)``, each of shape (line,).

    Equivalent to the reference per-row np.polyfit (utils.py:138-160):
    NaNs are first replaced by the column mean, then the samples that are
    still not finite are excluded from the fit by zero weights (weighted least
    squares on a line, the sums taken along each row about the row's weighted
    means, so that no difference of large sums cancels). A row without a
    finite sample, or with one, gets NaN, like the reference's TypeError path.
    """
    filled = torch.where(torch.isnan(noise), col_mean, noise)
    noise_db = 10.0 * torch.log10(filled)
    w = torch.isfinite(noise_db)
    zero = noise_db.new_zeros(())
    sw = w.sum(1).to(noise_db.dtype)
    x_mean = torch.where(w, inc_1d, zero).sum(1) / sw
    y_mean = torch.where(w, noise_db, zero).sum(1) / sw
    dx = torch.where(w, inc_1d - x_mean[:, None], zero)
    dy = torch.where(w, noise_db - y_mean[:, None], zero)
    slope = (dx * dy).sum(1) / (dx * dx).sum(1)
    return slope, y_mean - slope * x_mean


def _line(slope, intercept, inc):
    """A fitted line in dB, 1 dB down, back to linear (utils.py:160)."""
    return 10.0 ** ((inc * slope + intercept - 1.0) / 10.0)


def _flatten_rows(noise, inc_1d, col_mean):
    """The flattened NESZ of every row: :func:`_row_fit`, then its lines."""
    slope, intercept = _row_fit(noise, inc_1d, col_mean)
    return _line(slope[:, None], intercept[:, None], inc_1d)


def nesz_row_fit(noise, inc_1d):
    """The scene-wide step of the flattening: ``noise`` (line, sample) linear
    NESZ, ``inc_1d`` (sample,) the incidence's column means, both tensors on
    one device. Returns each row's ``(slope, intercept)`` in dB against
    incidence (:func:`_row_fit`), computed in the inputs' dtype."""
    return _row_fit(noise, inc_1d, torch.nanmean(noise, dim=0))


def nesz_expand(slope, intercept, inc_1d, lo, hi):
    """The flattened NESZ over the flat row-major range ``[lo, hi)`` of the
    (line, sample) scene whose rows :func:`nesz_row_fit` fitted: each pixel's
    row line at its column's incidence, element for element the values
    :func:`nesz_flattening` gives there."""
    idx = torch.arange(lo, hi, device=slope.device)
    row = torch.div(idx, inc_1d.shape[0], rounding_mode="floor")
    col = idx - row * inc_1d.shape[0]
    return _line(slope[row], intercept[row], inc_1d[col])


@xarray_io
def nesz_flattening(noise, inc, device="cuda"):
    """Flatten NESZ by a per-row order-1 polynomial fit in dB (utils.py:94-163).

    `noise` is linear NESZ with shape (line, sample); `inc` the incidence
    array of the same shape. Incidence is reduced to its column mean (it is
    nearly constant along the line dim).
    """
    if np.ndim(_data(noise)) != 2:
        raise IndexError("Only 2D noise allowed")
    noise_t, inc_t = _tensors(device, _data(noise), _data(inc))
    inc_1d = torch.nanmean(inc_t, dim=0)
    col_mean = torch.nanmean(noise_t, dim=0)
    return _wrap_like(noise, _flatten_rows(noise_t, inc_1d, col_mean))
