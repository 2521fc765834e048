"""The port's xarray bridge: DataArrays in, DataArrays out at its entry points.

Counterparts of the cases of tests/test_xarray_interop.py (the gradients
case apart, which waits for that module), against the protocol stub
tests/_xr_stub.py: the bridge is duck-typed and imports no xarray. The same
calls run on the JAX package. Tolerances: the port's DataArray results equal
its own numpy results bit for bit; against the JAX package the winds equal
``exact`` mode's up to the phi = +-180 deg tie and 1e-13 relative, detrended
sigma0 agrees to rtol 1e-10, dsig to 1e-12 and flattened NESZ to 1e-9.
"""

import logging

import numpy as np
import torch

from _xr_stub import DataArray, Dataset

import xsarsea_tpu as J
from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu.windspeed import get_dsig as jax_get_dsig, nesz_flattening as jax_nesz
import xsarsea_tpu_torch as P
from xsarsea_tpu_torch import sigma0_detrend
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.interop import (is_dataarray_like, to_dataarray, to_dataset,
                                       to_dimarray, xarray_io)
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.windspeed import get_dsig, invert_from_model, nesz_flattening

from test_streaming import LazyRows
from test_torch_inversion import F64_TRIG, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=0.4, wspd_step=0.4, phi_step=2.5)


def _scene(H=32, W=48, seed=0):
    rng = np.random.default_rng(seed)
    inc = np.linspace(19.0, 45.0, W)[None, :].repeat(H, 0)
    speed = rng.uniform(2.0, 24.0, (H, W))
    direc = rng.uniform(-np.pi, np.pi, (H, W))
    s0_co = get_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc))).numpy()
    s0_cr = get_model("gmf_s1_v2")(inc, speed, broadcast=True).numpy()
    return inc, s0_co, s0_cr, speed * np.exp(1j * direc), speed


def _da(data, name=None, **attrs):
    h, w = np.shape(data)[:2]
    return DataArray(data, dims=("line", "sample"),
                     coords={"line": np.arange(h, dtype=float),
                             "sample": np.arange(w, dtype=float)}, name=name, attrs=attrs)


def test_detection_and_conversion():
    da = _da(np.zeros((4, 5)), name="x", units="1")
    assert is_dataarray_like(da)
    assert not is_dataarray_like(np.zeros((4, 5))) and not is_dataarray_like(torch.zeros(4, 5))
    da.coords["pol"] = np.asarray("VV")
    da.coords["lat"] = np.zeros((4, 5))  # a 2-D auxiliary coord is dropped
    dim = to_dimarray(da)
    assert isinstance(dim, DimArray) and not is_dataarray_like(dim)
    assert dim.dims == ("line", "sample") and dim.attrs["units"] == "1" and dim.name == "x"
    assert set(dim.coords) == {"line", "sample", "pol"}
    ref = J.to_dimarray(da)
    assert ref.dims == dim.dims and set(ref.coords) == set(dim.coords)
    back = to_dataarray(dim, DataArray)
    assert isinstance(back, DataArray) and back.dims == ("line", "sample")
    np.testing.assert_array_equal(back.coords["line"], np.arange(4.0))
    assert back.attrs["units"] == "1" and back.coords["pol"] == "VV"
    # a tensor payload lands in the caller's DataArray as numpy
    out = to_dataarray(dim.to("cpu"), DataArray)
    assert isinstance(out.data, np.ndarray)
    ds = to_dataset({"a": dim, "b": dim * 2.0}, DataArray)
    assert isinstance(ds, Dataset) and isinstance(ds["b"], DataArray)
    assert to_dataset({"a": dim}, type("Orphan", (), {"__module__": "no_such_module"})) is None


def test_invert_from_model_dataarrays_roundtrip(caplog):
    inc, s0_co, s0_cr, anc, speed = _scene()
    with caplog.at_level(logging.INFO, logger="xsarsea_tpu_torch"):
        wco, wdual = invert_from_model(
            _da(inc), _da(s0_co, name="sigma0"), _da(s0_cr), ancillary_wind=_da(anc),
            dsig_cr=_da(np.full(inc.shape, 0.1)), model=MODEL, device="cpu", **KW)
    assert any("timing invert_from_model" in r.message for r in caplog.records)
    for out in (wco, wdual):
        assert isinstance(out, DataArray) and out.dims == ("line", "sample")
        assert out.shape == s0_co.shape and out.name == "windspeed_gmf"
        assert "model" in out.attrs and "comment" in out.attrs
    assert np.sqrt(np.nanmean((np.abs(wdual.values) - speed) ** 2)) < 0.5
    # numpy in -> numpy out is untouched by the adapter
    wco2, wdual2 = invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=0.1,
                                     model=MODEL, device="cpu", **KW)
    assert isinstance(wco2, np.ndarray)
    np.testing.assert_array_equal(wco.values, wco2)
    np.testing.assert_array_equal(wdual.values, wdual2)
    jco, jdual = jinv.invert_from_model(
        _da(inc), _da(s0_co, name="sigma0"), _da(s0_cr), ancillary_wind=_da(anc), dsig_cr=0.1,
        model=MODEL, mode="exact", device_db=False, **KW)
    assert isinstance(jco, DataArray)
    assert_parity(wco.values.reshape(-1), np.asarray(jco.values).reshape(-1), F64_TRIG)
    assert_parity(wdual.values.reshape(-1), np.asarray(jdual.values).reshape(-1), F64_TRIG)


def test_detrend_dataarray_roundtrip():
    inc, s0_co, _, _, _ = _scene()
    s0 = _da(np.abs(s0_co), name="sigma0", units="linear")
    out = sigma0_detrend(s0, _da(inc), device="cpu")
    assert isinstance(out, DataArray) and out.dims == ("line", "sample")
    assert "detrended with model" in out.attrs["comment"] and out.attrs["units"] == "linear"
    np.testing.assert_array_equal(out.values, sigma0_detrend(np.abs(s0_co), inc, device="cpu"))
    ref = J.sigma0_detrend(s0, _da(inc))
    np.testing.assert_allclose(out.values, np.asarray(ref.values), rtol=1e-10)


def test_dsig_and_nesz_dataarray_roundtrip():
    inc, _, s0_cr, _, _ = _scene()
    nesz = np.full_like(s0_cr, 1e-3)
    ds = get_dsig("gmf_s1_v2", _da(inc), _da(s0_cr), _da(nesz), device="cpu")
    assert isinstance(ds, DataArray) and ds.dims == ("line", "sample")
    np.testing.assert_array_equal(ds.values, get_dsig("gmf_s1_v2", inc, s0_cr, nesz,
                                                      device="cpu"))
    np.testing.assert_allclose(ds.values, np.asarray(jax_get_dsig("gmf_s1_v2", inc, s0_cr, nesz)),
                               rtol=1e-12)
    noise = np.abs(np.random.default_rng(1).normal(1e-3, 1e-4, inc.shape))
    flat = nesz_flattening(_da(noise), _da(inc), device="cpu")
    assert isinstance(flat, DataArray)
    np.testing.assert_array_equal(flat.values, nesz_flattening(noise, inc, device="cpu"))
    np.testing.assert_allclose(flat.values, np.asarray(jax_nesz(noise, inc)), rtol=1e-9)


def test_aux_coords_restored_from_template():
    inc, s0_co, _, _, _ = _scene(16, 20)
    lat = np.linspace(40.0, 41.0, 16)[:, None].repeat(20, 1)
    da = _da(np.abs(s0_co), name="sigma0")
    da.coords["lat"] = lat
    out = sigma0_detrend(da, _da(inc), device="cpu")
    assert "lat" in out.coords
    np.testing.assert_array_equal(np.asarray(out.coords["lat"]), lat)


def test_to_dataarray_keeps_chunked_payload_lazy():
    base = np.arange(12.0).reshape(4, 3)
    pulls = []

    def get(i, j):
        pulls.append((i, j))
        return base[i:j]

    lazy = LazyRows(get, base.shape, dtype=base.dtype)
    coords = {"line": np.arange(4.0), "sample": np.arange(3.0)}
    out = to_dataarray(DimArray(lazy, dims=("line", "sample"), coords=coords), DataArray)
    assert out.data is lazy and pulls == []  # still the duck array, nothing read
    assert to_dimarray(out).data is lazy and pulls == []  # and lazy on the way back in
    np.testing.assert_array_equal(np.asarray(out.values), base)


def test_invert_chunked_dataarray_stub():
    inc, s0_co, s0_cr, anc, _ = _scene()
    kw = dict(dsig_cr=0.1, model=MODEL, mode="exact", device="cpu", **KW)
    co_ref, dual_ref = invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, **kw)
    lz = {k: LazyRows(lambda i, j, a=a: a[i:j], a.shape, dtype=a.dtype)
          for k, a in dict(inc=inc, s0_co=s0_co, s0_cr=s0_cr, anc=anc).items()}
    co_x, dual_x = invert_from_model(
        _da(lz["inc"]), _da(lz["s0_co"], name="sigma0"), _da(lz["s0_cr"]),
        ancillary_wind=_da(lz["anc"]), piece_size=512, **kw)
    assert isinstance(co_x, DataArray) and co_x.dims == ("line", "sample")
    np.testing.assert_array_equal(np.asarray(co_x.values), co_ref)
    np.testing.assert_array_equal(np.asarray(dual_x.values), dual_ref)
    for name, arr in lz.items():
        assert 0 < arr.max_request <= 512 + 2 * inc.shape[1], (name, arr.max_request)


def test_xarray_io_converts_kwargs_and_passes_native_results():
    """Every DataArray-like argument is converted, keyword ones too; the
    first one seen is the template; a call without one returns what the
    function returned."""
    seen = {}

    @xarray_io
    def fn(a, b=None, flag=3):
        seen.update(a=a, b=b, flag=flag)
        return a, flag, (b if b is not None else a) * 2.0

    x, y = _da(np.ones((2, 3)), name="x"), _da(np.full((2, 3), 2.0), name="y")
    out = fn(x, b=y)
    assert isinstance(seen["a"], DimArray) and isinstance(seen["b"], DimArray)
    assert isinstance(out[0], DataArray) and out[1] == 3 and isinstance(out[2], DataArray)
    np.testing.assert_array_equal(out[2].values, 4.0)
    native = fn(DimArray(np.ones(2)))
    assert isinstance(native[0], DimArray) and isinstance(native[2], DimArray)
    assert P.to_dimarray is to_dimarray and P.to_dataarray is to_dataarray
