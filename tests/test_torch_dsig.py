"""The port's dsig weightings and NESZ flattening against the JAX package's,
on the CPU (``device="cpu"``), on the inputs tests/test_dsig.py builds.

Tolerances: ``get_dsig`` and ``get_dsig_wspd`` agree to rtol 1e-12 in float64
(torch's and XLA's ``exp``, ``pow`` and ``sqrt``). ``nesz_flattening`` agrees
to rtol 1e-9 in float64. In float32 the port and the JAX package each lose
digits in the line fit's ``sw * sxx - sx * sx``, in different summation
orders: each stays within rtol 1e-4 of the float64 answer and the two within
1e-4 of each other (measured: 1.0e-5, 1.2e-5 and 1.1e-5). The dtype that went
in comes out.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu.windspeed import (get_dsig as jax_get_dsig, get_dsig_wspd as jax_get_dsig_wspd,
                                   nesz_flattening as jax_nesz)
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.windspeed import get_dsig, get_dsig_wspd, nesz_flattening
from xsarsea_tpu_torch.windspeed.dsig import _flatten_rows

DSIG_NAMES = ("gmf_s1_v2", "gmf_rs2_v2", "sarwing_lut_cmodms1ahw", "nc_lut_cmodms1ahw")
WSPD_NAMES = ("dsig_wspd_rs2_v3", "dsig_wspd_s1_ew_rec_v3", "dsig_wspd_rcm_v3")


@pytest.mark.parametrize("name", DSIG_NAMES)
def test_get_dsig_schemes(name):
    rng = np.random.default_rng(0)
    inc = rng.uniform(18, 45, size=(6, 7))
    s0 = rng.uniform(1e-4, 1e-2, size=(6, 7))
    nesz = rng.uniform(1e-5, 1e-3, size=(6, 7))
    got = get_dsig(name, inc, s0, nesz, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(jax_get_dsig(name, inc, s0, nesz)), rtol=1e-12)
    # a tensor in, a tensor out on its device; a DimArray in, a DimArray out
    t = get_dsig(name, *(torch.as_tensor(a) for a in (inc, s0, nesz)), device="cpu")
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), got)
    da = get_dsig(name, inc, DimArray(s0, dims=("line", "sample"), attrs={"units": "linear"}),
                  nesz, device="cpu")
    assert isinstance(da, DimArray) and da.dims == ("line", "sample") and da.attrs == {}
    np.testing.assert_array_equal(da.values, got)


def test_get_dsig_unknown_name():
    with pytest.raises(ValueError, match="not handled"):
        get_dsig("unknown", 1.0, 1.0, 1.0, device="cpu")
    with pytest.raises(ValueError, match="unknown dsig_wspd"):
        get_dsig_wspd("unknown", 1.0, 1.0, device="cpu")


@pytest.mark.parametrize("name", WSPD_NAMES)
def test_get_dsig_wspd(name):
    rng = np.random.default_rng(1)
    u = rng.uniform(0, 40, size=(5, 5))
    snr = rng.uniform(0, 10, size=(5, 5))
    got = get_dsig_wspd(name, u, snr, device="cpu")
    np.testing.assert_allclose(got, np.asarray(jax_get_dsig_wspd(name, u, snr)), rtol=1e-12)
    np.testing.assert_allclose(get_dsig_wspd(name, u, snr, Umax=20.0, device="cpu"),
                               np.asarray(jax_get_dsig_wspd(name, u, snr, Umax=20.0)),
                               rtol=1e-12)
    assert got.min() >= 0.0 and got.max() <= 1.0
    scalar = get_dsig_wspd(name, 12.0, 3.0, device="cpu")
    np.testing.assert_allclose(scalar, np.asarray(jax_get_dsig_wspd(name, 12.0, 3.0)),
                               rtol=1e-12)


def _nesz_scene():
    rng = np.random.default_rng(2)
    ny, nx = 12, 40
    inc = np.linspace(18, 45, nx)[None, :].repeat(ny, axis=0)
    inc += rng.normal(0, 0.01, size=inc.shape)
    # noise decays with incidence in dB plus per-row structure
    noise = 10 ** ((-25.0 - 0.15 * inc + rng.normal(0, 0.8, size=(ny, nx))) / 10.0)
    noise[2, 5] = np.nan  # replaced by the column mean before the fit
    noise[7, [0, 1, 2]] = np.nan
    return noise, inc


def test_nesz_flattening_parity():
    noise, inc = _nesz_scene()
    got = nesz_flattening(noise, inc, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64 and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax_nesz(noise, inc)), rtol=1e-9)
    da = nesz_flattening(DimArray(noise, dims=("line", "sample")), inc, device="cpu")
    assert isinstance(da, DimArray)
    np.testing.assert_array_equal(da.values, got)


def test_nesz_flattening_float32_keeps_dtype():
    noise, inc = _nesz_scene()
    f64 = nesz_flattening(noise, inc, device="cpu")
    got = nesz_flattening(noise.astype(np.float32), inc.astype(np.float32), device="cpu")
    assert got.dtype == np.float32
    ref = np.asarray(jax_nesz(noise.astype(np.float32), inc.astype(np.float32)))
    assert ref.dtype == np.float32
    np.testing.assert_allclose(got, f64, rtol=1e-4)
    np.testing.assert_allclose(ref, f64, rtol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_nesz_flattening_all_nan_row_and_column():
    nx = 30
    inc = np.linspace(18, 45, nx)[None, :].repeat(3, axis=0)
    noise = np.full((3, nx), 1e-3)
    noise[1, :] = np.nan  # the column means still fill it: the fit runs
    got = nesz_flattening(noise, inc, device="cpu")
    np.testing.assert_allclose(got, np.asarray(jax_nesz(noise, inc)), rtol=1e-9, equal_nan=True)
    assert np.isfinite(got).all()
    noise[:] = np.nan  # nothing to fill with: every row has sw == 0 -> NaN rows
    got = nesz_flattening(noise, inc, device="cpu")
    assert np.isnan(got).all() and np.isnan(np.asarray(jax_nesz(noise, inc))).all()
    # zero weights for samples that stay non-finite after the fill (log10 of 0)
    rows = _flatten_rows(torch.tensor([[1e-3, 0.0, 1e-3, 2e-3]], dtype=torch.float64),
                         torch.tensor([20.0, 25.0, 30.0, 35.0], dtype=torch.float64),
                         torch.full((4,), 1e-3, dtype=torch.float64))
    assert torch.isfinite(rows).all()


def test_nesz_flattening_requires_2d():
    with pytest.raises(IndexError):
        nesz_flattening(np.zeros(5), np.zeros(5), device="cpu")
    with pytest.raises(IndexError):
        nesz_flattening(np.zeros(5), np.zeros(5))  # before any device is asked for


def test_default_device_is_cuda_and_raises_without_a_card():
    """``device`` defaults to ``"cuda"``; without a card the call raises and
    nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    noise, inc = _nesz_scene()
    from xsarsea_tpu_torch import sigma0_detrend
    for call in (lambda: nesz_flattening(noise, inc), lambda: sigma0_detrend(noise, inc),
                 lambda: get_dsig("gmf_s1_v2", inc, noise, noise),
                 lambda: get_dsig_wspd(WSPD_NAMES[0], inc, inc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
