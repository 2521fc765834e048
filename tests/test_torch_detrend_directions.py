"""The port's direction conversions and ``sigma0_detrend`` against the JAX
package's, on the CPU.

Tolerances: the six conversions on numpy arrays and floats are bit-equal to
the JAX module's (the same numpy arithmetic; ``x * (pi / 180)`` is what
``np.deg2rad`` computes); on tensors they equal the numpy results bit for
bit too (``torch.remainder`` is numpy's ``%``), negative angles included.
``sigma0_detrend`` agrees with the JAX function to rtol 1e-10 in float64 for
an analytic model (torch's and XLA's transcendental functions in the GMF)
and for a tabulated one (the same LUT interp on the host).
"""

import os

import numpy as np
import pytest
import torch

import xsarsea_tpu as J
import xsarsea_tpu.directions as jdir
import xsarsea_tpu.models as JM
import xsarsea_tpu_torch as P
import xsarsea_tpu_torch.directions as pdir
import xsarsea_tpu_torch.models as PM
from xsarsea_tpu_torch.dimarray import DimArray

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NAMES = ["dir_meteo_to_sample", "dir_sample_to_meteo", "dir_meteo_to_oceano",
         "dir_oceano_to_meteo", "dir_to_180", "dir_to_360"]


@pytest.mark.parametrize("fn_name", NAMES)
def test_direction_conversions_match_jax_module(fn_name):
    rng = np.random.default_rng(0)
    ours, ref = getattr(pdir, fn_name), getattr(jdir, fn_name)
    assert getattr(P, fn_name) is ours
    angles = np.concatenate([rng.uniform(-720.0, 720.0, 200),
                             [-360.0, -180.0, -0.0, 0.0, 180.0, 360.0, 540.0, -1e-9]])
    args = (angles,)
    if fn_name in ("dir_meteo_to_sample", "dir_sample_to_meteo"):
        args += (rng.uniform(-180.0, 360.0, angles.size),)
    want = ref(*args)
    np.testing.assert_array_equal(ours(*args), want)                      # numpy: bit-equal
    got_t = ours(*(torch.as_tensor(a) for a in args))                     # tensors
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert ours(*(float(a[3]) for a in args)) == want[3]                  # floats
    for kind in (np.asarray, torch.as_tensor):                            # DimArrays
        da = ours(*(DimArray(kind(a), dims=("x",)) for a in args))
        assert isinstance(da, DimArray) and isinstance(da.data, type(kind(angles)))
        np.testing.assert_array_equal(da.values, want)
    if fn_name == "dir_to_180":
        assert want.min() >= -180.0 and want.max() < 180.0
    if fn_name in ("dir_to_360", "dir_meteo_to_oceano", "dir_oceano_to_meteo"):
        assert want.min() >= 0.0 and want.max() < 360.0


def _scene(h=40, w=120):
    rng = np.random.default_rng(0)
    inc = np.linspace(19.0, 46.0, w)[None, :].repeat(h, 0)
    sigma0 = rng.uniform(1e-3, 0.5, (h, w))
    sigma0[3, 5] = np.nan
    return sigma0, inc


def test_sigma0_detrend_analytic_model():
    sigma0, inc = _scene()
    dims = ("line", "sample")
    got = P.sigma0_detrend(DimArray(sigma0, dims=dims, attrs={"units": "linear"}),
                           DimArray(inc, dims=dims), device="cpu")
    ref = J.sigma0_detrend(J.DimArray(sigma0, dims=dims), J.DimArray(inc, dims=dims))
    assert isinstance(got, DimArray) and isinstance(got.data, np.ndarray)
    assert got.attrs == {"units": "linear", "comment": "detrended with model gmf_cmod5n"}
    assert got.attrs["comment"] == ref.attrs["comment"]
    np.testing.assert_allclose(got.values, np.asarray(ref.data), rtol=1e-10)
    assert np.isnan(got.values[3, 5])
    # the reference algorithm by hand: the GMF on the first line at (10 m/s, 45 deg)
    row = PM.get_model("gmf_cmod5n")(inc[0], np.full(inc.shape[1], 10.0),
                                     np.full(inc.shape[1], 45.0), broadcast=True).numpy()
    np.testing.assert_allclose(got.values, sigma0 / (row / np.nanmean(row))[None, :], rtol=1e-12)
    # other wind, plain arrays, tensors in -> tensor out, float32 stays float32
    kw = dict(wind_speed_gmf=7.0, wind_dir_gmf=[120.0], model="cmod5n")
    plain = P.sigma0_detrend(sigma0, inc, device="cpu", **kw)
    assert isinstance(plain, np.ndarray)
    np.testing.assert_allclose(plain, np.asarray(J.sigma0_detrend(sigma0, inc, **kw)), rtol=1e-10)
    t = P.sigma0_detrend(torch.as_tensor(sigma0), torch.as_tensor(inc), device="cpu", **kw)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), plain)
    f32 = P.sigma0_detrend(sigma0.astype(np.float32), inc.astype(np.float32), device="cpu")
    assert f32.dtype == np.float32
    np.testing.assert_allclose(f32, got.values, rtol=1e-5)


def test_sigma0_detrend_tabulated_model():
    for M in (JM, PM):
        M.register_pickle_luts(os.path.join(DATA, "sarwing_luts"))
    sigma0, inc = _scene(12, 60)
    inc = inc * 0 + np.linspace(20.0, 44.0, 60)
    for name in ("sarwing_lut__fix_co_2_1", "sarwing_lut__fix_cr_2_1"):
        got = P.sigma0_detrend(sigma0, inc, model=name, device="cpu")
        ref = np.asarray(J.sigma0_detrend(sigma0, inc, model=name))
        assert np.isfinite(got[0]).all()
        np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_sigma0_detrend_scalar_size_check():
    sigma0, inc = _scene(4, 8)
    for kw in (dict(wind_speed_gmf=[5.0, 6.0]), dict(wind_dir_gmf=np.zeros(2))):
        with pytest.raises(ValueError, match="scalars"):
            P.sigma0_detrend(sigma0, inc, device="cpu", **kw)
    with pytest.raises(KeyError):
        P.sigma0_detrend(sigma0, inc, model="no_such_model", device="cpu")
