"""The port's native LUT codec (``xsarsea_tpu_torch/native/lutio.cpp``) against
its Python paths and the JAX package's, on the CPU.

The source is built here with ``g++`` against ``sysconfig``'s include path and
numpy's headers, and loaded under its module name ``xsarsea_tpu_torch._lutio``
(as ``python setup.py build_ext --inplace`` installs it). Counterpart of
``tests/test_io_cli.py:26-86``: the packed round trip, native and Python files
byte-identical, the JAX package's Python reader reading both, and the CMOD7
decode on the KNMI fixture equal, bit for bit, to the port's Python decode
and to the JAX package's.
"""

import gzip
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

import xsarsea_tpu_torch
from xsarsea_tpu.io import lut_io as jio
from xsarsea_tpu.models.cmod7 import Cmod7Model as JCmod7
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.io import lut_io as pio
from xsarsea_tpu_torch.models.cmod7 import Cmod7Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "xsarsea_tpu_torch", "native", "lutio.cpp")
CMOD7_GZ = os.path.join(ROOT, "tests", "data", "knmi_cmod7", "cmod7",
                        "gmf_cmod7_vv.dat_little_endian.gz")
NAME = "xsarsea_tpu_torch._lutio"


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """Path of the codec built from the checkout's source."""
    out = tmp_path_factory.mktemp("lutio") / ("_lutio" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
                    SOURCE, "-o", str(out)], check=True, capture_output=True, timeout=240)
    return str(out)


@pytest.fixture
def native(native_build, monkeypatch):
    """The built codec, importable as ``xsarsea_tpu_torch._lutio`` for one
    test."""
    spec = importlib.util.spec_from_file_location(NAME, native_build)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, NAME, mod)
    monkeypatch.setattr(xsarsea_tpu_torch, "_lutio", mod, raising=False)
    return mod


@pytest.fixture
def python_only(monkeypatch):
    """No codec: the Python paths."""
    monkeypatch.setitem(sys.modules, NAME, None)
    monkeypatch.delattr(xsarsea_tpu_torch, "_lutio", raising=False)


@pytest.fixture(scope="module")
def cmod7_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("knmi") / "cmod7"
    d.mkdir()
    with gzip.open(CMOD7_GZ, "rb") as f_in, \
            open(d / "gmf_cmod7_vv.dat_little_endian", "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    return str(d)


def make_lut():
    rng = np.random.default_rng(0)
    data = rng.uniform(-40.0, 5.0, (11, 25, 7)).astype(np.float32)
    return DimArray(data, dims=("incidence", "wspd", "phi"),
                    coords={"incidence": np.linspace(16.0, 66.0, 11),
                            "wspd": np.linspace(0.2, 50.0, 25), "phi": np.linspace(0.0, 180.0, 7)},
                    attrs={"units": "dB", "model": "test", "resolution": "high"})


def test_module_name(native):
    assert native.__name__ == NAME
    from xsarsea_tpu_torch import _lutio

    assert _lutio is native


def test_packed_roundtrip_native(tmp_path, native):
    lut = make_lut()
    pio.write_packed_lut(tmp_path / "lut.xstl", lut, lut.attrs)
    back = pio.read_packed_lut(tmp_path / "lut.xstl")
    assert back.dims == lut.dims and back.attrs == lut.attrs
    np.testing.assert_array_equal(back.values, lut.values)
    for d in lut.dims:
        np.testing.assert_array_equal(np.asarray(back.coords[d]), lut.coords[d])


def test_packed_native_and_python_files_identical(tmp_path, native, monkeypatch):
    lut = make_lut()
    p_py, p_native = tmp_path / "py.xstl", tmp_path / "native.xstl"
    with monkeypatch.context() as m:  # the Python writer and reader
        m.setitem(sys.modules, NAME, None)
        m.delattr(xsarsea_tpu_torch, "_lutio")
        pio.write_packed_lut(p_py, lut, lut.attrs)
        from_py = pio.read_packed_lut(p_py)
    pio.write_packed_lut(p_native, lut, lut.attrs)
    assert p_native.read_bytes() == p_py.read_bytes()
    # each reader reads each file alike, the JAX package's Python reader too
    for path in (p_py, p_native):
        for back in (pio.read_packed_lut(path), jio.read_packed_lut(path), from_py):
            np.testing.assert_array_equal(np.asarray(back.data), lut.values)
            assert back.attrs == lut.attrs and tuple(back.dims) == lut.dims


def test_packed_native_rejects_other_files(tmp_path, native):
    bad = tmp_path / "bad.xstl"
    bad.write_bytes(b"NOTXSTL")
    with pytest.raises(ValueError, match="not an XSTL1 file"):
        pio.read_packed_lut(bad)
    with pytest.raises(FileNotFoundError):
        native.read_packed(str(tmp_path / "absent.xstl"))


@pytest.mark.parametrize("route", ["native", "python"])
def test_cmod7_decode_equals_jax(route, cmod7_dir, request):
    request.getfixturevalue("native" if route == "native" else "python_only")
    lut = Cmod7Model(f"gmf_cmod7_lutio_{route}", cmod7_dir, pol="VV")._raw_lut()
    ref = JCmod7(f"gmf_cmod7_lutio_{route}", cmod7_dir, pol="VV")._raw_lut()
    assert lut.dims == ("incidence", "wspd", "phi") and lut.values.shape == (51, 250, 73)
    assert lut.values.dtype == np.float32 and lut.values.flags.c_contiguous
    np.testing.assert_array_equal(lut.values, np.asarray(ref.data))
    raw = np.fromfile(os.path.join(cmod7_dir, "gmf_cmod7_vv.dat_little_endian"), "<f4")[1:-1]
    np.testing.assert_array_equal(lut.values, raw.reshape((250, 73, 51), order="F")
                                  .transpose(2, 0, 1))


def test_cmod7_decode_native_rejects_wrong_size(tmp_path, native):
    (tmp_path / "gmf_cmod7_vv.dat_little_endian").write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a CMOD7"):
        native.decode_cmod7(str(tmp_path / "gmf_cmod7_vv.dat_little_endian"))
