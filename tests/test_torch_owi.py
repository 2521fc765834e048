"""The scene-preparation chain on the port, from an OWI file to winds, on
the CPU: ``read_sarwing_owi`` -> ``dir_meteo_to_sample`` -> ``nesz_flattening``
-> ``get_dsig`` -> ``invert_from_model`` on labelled arrays, as
tests/test_owi_integration.py walks it on the JAX package, on the same
synthesized HDF5 file (needs ``h5py``).

Tolerances: the reader returns the file's arrays bit for bit in both
packages; flattened NESZ agrees to rtol 1e-9; the port's winds
(``device="cpu"``: float64, exact argmin) equal the JAX chain's in ``exact``
mode up to the phi = +-180 deg tie and 1e-13 relative, each chain fed its
own flattened NESZ; the dual-pol speed's RMS against the true wind is under
1.0 m/s.
"""

import sys
import types

import numpy as np
import torch

import _xr_stub
import xsarsea_tpu as J
from xsarsea_tpu.windspeed import inversion as jinv, nesz_flattening as jax_nesz
import xsarsea_tpu_torch as P
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.windspeed import get_dsig, invert_from_model, nesz_flattening

from test_owi_integration import owi_file  # noqa: F401  (the synthesized scene)
from test_torch_inversion import F64_TRIG, SMALL, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")


def _chain(pkg, ds, flatten, invert, dsig_of, **kw):
    """The chain of tests/test_owi_integration.py:78-98 on one package."""
    anc = ds["owiEcmwfWindSpeed"] * np.exp(1j * np.asarray(pkg.dir_meteo_to_sample(
        ds["owiEcmwfWindDirection"].data, ds["owiHeading"].data)))
    nesz_flat = flatten(ds["owiNesz_cross"], ds["owiIncidenceAngle"])
    dsig_cr = dsig_of(ds["owiNrcs_cross"], nesz_flat)
    winds = invert(ds["owiIncidenceAngle"], ds["owiNrcs"], ds["owiNrcs_cross"],
                   ancillary_wind=anc, dsig_cr=dsig_cr, model=MODEL, **SMALL, **kw)
    return nesz_flat, dsig_cr, winds


def test_owi_read_compose_invert(owi_file):  # noqa: F811
    path, true_speed = owi_file
    ds = P.read_sarwing_owi(path)
    ref_ds = J.read_sarwing_owi(path)

    # reader contract (reference detrend.py:71-93), and the JAX reader's arrays
    assert isinstance(ds, dict) and set(ds) == set(ref_ds)
    assert "owiCalConstObsi" not in ds and "owiWindSpeed_Tab_dualpol_2steps" in ds
    for k, v in ds.items():
        assert isinstance(v, DimArray) and v.dims == ("line", "sample") and v.name == k
        np.testing.assert_array_equal(v.data, np.asarray(ref_ds[k].data))
        np.testing.assert_array_equal(v.coords["sample"], np.arange(v.shape[1]))

    nesz_flat, dsig_cr, (wind_co, wind_dual) = _chain(
        P, ds, lambda n, i: nesz_flattening(n, i, device="cpu"), invert_from_model,
        lambda s0, nesz: get_dsig("nc_lut_cmodms1ahw", 0.0, s0, nesz, device="cpu"),
        device="cpu")
    assert isinstance(nesz_flat, DimArray) and isinstance(dsig_cr, DimArray)
    # the sarwing weighting by name is the chain's (1.25 / (s0 / nesz)) ** 4
    np.testing.assert_allclose(
        dsig_cr.values, (1.25 / (ds["owiNrcs_cross"].values / nesz_flat.values)) ** 4.0,
        rtol=1e-12)

    # container/dtype/attrs contract (test_xsarsea.py:109-143)
    for out in (wind_co, wind_dual):
        assert isinstance(out, DimArray) and out.dims == ("line", "sample")
        assert out.values.dtype == np.complex128
        assert "model" in out.attrs and "comment" in out.attrs
    assert "gmf_s1_v2" in wind_dual.attrs["model"]
    co_speed, dual_speed = np.abs(wind_co.values), np.abs(wind_dual.values)
    assert np.isnan(co_speed[6, 6])        # land: NaN copol sigma0 -> NaN copol wind
    assert np.isfinite(dual_speed[6, 6])   # crosspol fills in over land
    m = np.isfinite(dual_speed)
    rms = np.sqrt(np.mean((dual_speed[m] - true_speed[m]) ** 2))
    assert rms < 1.0, f"dual-pol retrieval RMS {rms}"

    # the same chain on the JAX package, exact mode
    ref_flat, _, (ref_co, ref_dual) = _chain(
        J, ref_ds, jax_nesz, jinv.invert_from_model,
        lambda s0, nesz: (1.25 / (s0 / nesz)) ** 4.0, mode="exact", device_db=False)
    np.testing.assert_allclose(nesz_flat.values, np.asarray(ref_flat.data), rtol=1e-9)
    assert_parity(wind_co.values.reshape(-1), np.asarray(ref_co.data).reshape(-1), F64_TRIG)
    assert_parity(wind_dual.values.reshape(-1), np.asarray(ref_dual.data).reshape(-1), F64_TRIG)


def test_owi_reader_returns_dataset_with_xarray(owi_file, monkeypatch):  # noqa: F811
    """With xarray importable, read_sarwing_owi returns its Dataset
    (reference detrend.py:71-93 parity); a dict otherwise."""
    stub = types.ModuleType("xarray")
    stub.DataArray = _xr_stub.DataArray
    stub.Dataset = _xr_stub.Dataset
    monkeypatch.setitem(sys.modules, "xarray", stub)
    path, _ = owi_file
    ds = P.read_sarwing_owi(path)
    assert isinstance(ds, _xr_stub.Dataset)
    assert "owiNrcs" in ds and "owiWindSpeed_Tab_dualpol_2steps" in ds
    assert ds["owiNrcs"].dims == ("line", "sample") and "owiCalConstObsi" not in ds
    assert isinstance(ds["owiNrcs"].data, np.ndarray)
