"""The port's LUT-file models and LUT I/O against the JAX package's, on the
fixtures that tests/test_real_format_fixtures.py reads (tests/data/).

Every loader's ``to_lut(units="dB")`` must equal the JAX package's: coords
and data bit-equal in float64, at the file's own grid, at the low-res grid
and (CMOD7) re-gridded. Both packages re-grid with the same numpy lerp in
the file's dtype, so no tolerance is needed.
"""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import xsarsea_tpu.models as J
from xsarsea_tpu.io import lut_io as jio
import xsarsea_tpu_torch.models as P
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.io import lut_io as pio

torch.set_num_threads(min(2, torch.get_num_threads()))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CMOD7_GZ = os.path.join(DATA, "knmi_cmod7", "cmod7", "gmf_cmod7_vv.dat_little_endian.gz")


@pytest.fixture(scope="module")
def cmod7_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("knmi") / "cmod7"
    d.mkdir()
    with gzip.open(CMOD7_GZ, "rb") as f_in, \
            open(d / "gmf_cmod7_vv.dat_little_endian", "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    return str(d)


def assert_same_lut(a, b):
    """JAX DimArray ``a`` == port DimArray ``b``: dims, coords and data
    bit-equal in float64, NaN where NaN, the same dtype up to byte order
    (netCDF files hold big-endian data)."""
    assert tuple(a.dims) == tuple(b.dims)
    for d in a.dims:
        np.testing.assert_array_equal(np.asarray(b.coords[d], np.float64),
                                      np.asarray(a.coords[d], np.float64), err_msg=d)
    native = [np.asarray(x).dtype.newbyteorder("=") for x in (b.values, a.data)]
    assert native[0] == native[1]
    np.testing.assert_array_equal(np.asarray(b.values, np.float64),
                                  np.asarray(a.data, np.float64))


def _both(name, **kwargs):
    return (J.get_model(name).to_lut(units="dB", **kwargs),
            P.get_model(name).to_lut(units="dB", **kwargs))


@pytest.mark.parametrize("sub,pol,shape", [("GMF_fix_co_2_1", "VV", (34, 84, 25)),
                                           ("GMF_fix_cr_2_1", "VH", (67, 155))])
def test_pickle_luts_match_jax(sub, pol, shape):
    for M in (J, P):
        M.register_pickle_luts(os.path.join(DATA, "sarwing_luts", sub))
    name = "sarwing_lut__" + sub[len("GMF_"):]
    m = P.get_model(name)
    assert isinstance(m, P.PickleLutModel) and m.pol == pol
    assert P.available_models()[name]["alias"] == sub[len("GMF_"):]
    raw_j, raw_p = J.get_model(name)._raw_lut(), m._raw_lut()
    assert_same_lut(raw_j, raw_p)
    assert raw_p.attrs["units"] == "dB"
    a, b = _both(name)
    assert b.shape == shape  # the file fixes the high-res grid
    assert_same_lut(a, b)
    assert_same_lut(*_both(name, resolution="low"))
    # the file's ranges and steps became the model's
    for attr in ("inc_range", "wspd_range", "inc_step", "wspd_step"):
        assert getattr(m, attr) == getattr(J.get_model(name), attr)


def test_cmod7_matches_jax(cmod7_dir):
    for M in (J, P):
        M.register_cmod7(cmod7_dir)
    m = P.get_model("cmod7")
    assert isinstance(m, P.Cmod7Model) and m.name == "gmf_cmod7" and m.iscopol
    raw = m._raw_lut()
    assert raw.shape == (51, 250, 73) and raw.dtype == np.float32
    assert_same_lut(J.get_model("gmf_cmod7")._raw_lut(), raw)
    assert_same_lut(*_both("gmf_cmod7", resolution="low"))
    a, b = _both("gmf_cmod7", inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    assert b.shape == (101, 101, 37)
    assert_same_lut(a, b)


def test_nc_lut_hdf5_fixture_matches_jax():
    pytest.importorskip("h5py")
    for M in (J, P):
        M.register_nc_luts(os.path.join(DATA, "nc_luts"))
    m = P.get_model("nc_lut_fixmod")
    assert m.short_name == "gmf_fixmod" and m.pol == "VV" and m.units == "dB"
    np.testing.assert_allclose(m.inc_range, [17.0, 50.0])
    assert_same_lut(J.get_model("nc_lut_fixmod")._raw_lut(), m._raw_lut())
    assert_same_lut(*_both("nc_lut_fixmod"))
    assert_same_lut(*_both("nc_lut_fixmod", resolution="low"))


@pytest.mark.parametrize("model", ["gmf_cmod5n", "gmf_s1_v2"])
def test_netcdf_round_trip_matches_jax(tmp_path, model):
    """to_netcdf -> register_nc_luts -> get_model, in both packages; each
    package reads the other's file to the same LUT."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    P.get_model(model).to_netcdf(str(tmp_path / "port" / "nc_lut_rt.nc"))
    J.get_model(model).to_netcdf(str(tmp_path / "jax" / "nc_lut_rt.nc"))
    got = pio.read_lut_attrs(str(tmp_path / "port" / "nc_lut_rt.nc"))
    ref = jio.read_lut_attrs(str(tmp_path / "jax" / "nc_lut_rt.nc"))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for src in ("port", "jax"):
        P.register_nc_luts(str(tmp_path / src))
        J.register_nc_luts(str(tmp_path / src))
        m = P.get_model("nc_lut_rt")
        assert isinstance(m, P.NcLutModel) and m.pol == J.get_model(model).pol
        assert_same_lut(*_both("nc_lut_rt"))
        assert_same_lut(J.get_model("nc_lut_rt")._raw_lut(), m._raw_lut())
        # the file holds the writer's dB LUT at the written resolution (the
        # two packages' analytic GMFs differ at 1e-14, tests/test_torch_gmfs.py)
        res = "low" if m.iscopol else "high"
        writer = {"port": P, "jax": J}[src].get_model(model)
        assert_same_lut(writer.to_lut(units="dB", resolution=res), m._raw_lut())


def test_packed_round_trip_matches_jax(tmp_path):
    lut = P.get_model("gmf_cmod5n").to_lut(units="dB", resolution="low")
    pio.write_packed_lut(tmp_path / "port.xstl", lut)
    jio.write_packed_lut(tmp_path / "jax.xstl",
                         J.get_model("gmf_cmod5n").to_lut(units="dB", resolution="low"))
    assert (tmp_path / "port.xstl").read_bytes() == (tmp_path / "jax.xstl").read_bytes()
    back = pio.read_packed_lut(tmp_path / "jax.xstl")
    assert_same_lut(jio.read_packed_lut(tmp_path / "port.xstl"), back)
    assert back.dtype == np.float32 and back.attrs["units"] == "dB"
    np.testing.assert_array_equal(back.values, lut.values.astype(np.float32))
    (tmp_path / "bad").write_bytes(b"NOTXSTL")
    with pytest.raises(ValueError, match="XSTL1"):
        pio.read_packed_lut(tmp_path / "bad")


def test_lut_model_call_matches_jax():
    """Scalar and 1-D outer-product evaluation of a LUT model."""
    for M in (J, P):
        M.register_pickle_luts(os.path.join(DATA, "sarwing_luts"))
    for name, args in (("sarwing_lut__fix_co_2_1", (30.3, 10.05, 47.5)),
                       ("sarwing_lut__fix_cr_2_1", (30.3, 10.05))):
        assert P.get_model(name)(*args) == J.get_model(name)(*args)
        vec = tuple(np.linspace(a * 0.9, a, 4) for a in args)
        got, ref = P.get_model(name)(*vec), J.get_model(name)(*vec)
        assert isinstance(got, DimArray) and got.name == "sigma0_gmf"
        assert_same_lut(ref, got)
    with pytest.raises(NotImplementedError, match="scalar or 1D"):
        P.get_model("sarwing_lut__fix_cr_2_1")(np.ones((2, 2)), np.ones((2, 2)))


def test_register_luts_and_dimarray_helpers(cmod7_dir):
    P.register_luts(topdir=os.path.join(DATA, "nc_luts"), topdir_cmod7=cmod7_dir)
    assert isinstance(P.get_model("cmod7"), P.Cmod7Model)
    da = DimArray(np.arange(6.0).reshape(2, 3), dims=("a", "b"),
                  coords={"a": [0, 1], "b": [5, 6, 7]})
    t = da.transpose()
    assert t.dims == ("b", "a") and t.shape == (3, 2)
    np.testing.assert_array_equal(t.values, da.values.T)
    td = DimArray(torch.arange(6.0).reshape(2, 3), dims=("a", "b")).transpose("b", "a")
    np.testing.assert_array_equal(td.values, da.values.T)
    assert da.isel(a=1, b=2).item() == 5.0


def test_loaders_import_no_h5py_until_hdf5_read():
    """The card's machine has no h5py: only an HDF5 file may import it."""
    code = ("import sys, xsarsea_tpu_torch.models as M\n"
            f"M.register_pickle_luts({os.path.join(DATA, 'sarwing_luts')!r})\n"
            "M.get_model('sarwing_lut__fix_cr_2_1').to_lut(units='dB')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('h5py', 'jax'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
