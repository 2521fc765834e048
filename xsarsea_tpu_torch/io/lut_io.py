"""LUT (de)serialization (counterpart of ``xsarsea_tpu.io.lut_io``).

The reference persists LUTs as netCDF files with a fixed schema (variable
``sigma0_model`` over dims (incidence, wspd[, phi]), dB units, range/step
global attributes; ``models.py:232-262``):

* :func:`write_lut` writes classic netCDF (version 2) through scipy;
* :func:`read_lut` reads it back, and reads netCDF4-over-HDF5 files through
  ``h5py``, imported only for such a file;
* :func:`write_packed_lut` / :func:`read_packed_lut` keep the XSTL1 packed
  cache format (one f32 C-order block behind a JSON header), through the
  native codec ``xsarsea_tpu_torch._lutio`` when it is built
  (``python setup.py build_ext --inplace``) and in Python otherwise, with
  the same files and arrays either way.
"""

from __future__ import annotations

import json
import os

import numpy as np

from xsarsea_tpu_torch.dimarray import DimArray

__all__ = ["write_lut", "read_lut", "read_lut_attrs", "write_packed_lut", "read_packed_lut",
           "native_codec"]

_LUT_VAR = "sigma0_model"
_XSTL1 = b"XSTL1\n"


def _sanitize_attr(v):
    return np.asarray(v) if isinstance(v, (list, tuple)) else v


def write_lut(path, lut: DimArray, attrs: dict):
    """Write a LUT DimArray to a classic-netCDF file with the xsarsea schema."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w", version=2) as nc:
        for dim in lut.dims:
            nc.createDimension(dim, lut.sizes[dim])
            var = nc.createVariable(dim, "d", (dim,))
            var[:] = np.asarray(lut.coords[dim], dtype=np.float64)
        var = nc.createVariable(_LUT_VAR, "d", lut.dims)
        var[:] = np.asarray(lut.values, dtype=np.float64)
        for k, v in attrs.items():
            setattr(nc, k, _sanitize_attr(v))


def _is_hdf5(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89HDF\r\n\x1a\n"


def _decode(v):
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return v.astype(str)
    if isinstance(v, np.generic):
        return v.item()
    return v


def read_lut_attrs(path):
    """Only the global attributes of a LUT file (cheap registration scan)."""
    if _is_hdf5(path):
        import h5py

        with h5py.File(path, "r") as f:
            return {k: _decode(v) for k, v in f.attrs.items()}
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as nc:
        return {k: _decode(v) for k, v in nc._attributes.items()}


def _read_hdf5(path):
    import h5py

    with h5py.File(path, "r") as f:
        dset = f[_LUT_VAR]
        # netCDF4-over-HDF5 names a variable's dims by the dimension scales
        # attached to it; positional names when none is attached
        dims = []
        for i in range(dset.ndim):
            scales = dset.dims[i]
            name = scales[0].name.lstrip("/") if len(scales) else None
            dims.append(name or ("incidence", "wspd", "phi")[i])
        coords = {d: np.asarray(f[d]) for d in dims if d in f}
        attrs = {k: _decode(v) for k, v in f.attrs.items()}
        return np.asarray(dset), dims, coords, attrs


def read_lut(path) -> DimArray:
    """Read a LUT file into a DimArray (dims incidence, wspd[, phi])."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if _is_hdf5(path):
        data, dims, coords, attrs = _read_hdf5(path)
    else:
        from scipy.io import netcdf_file

        with netcdf_file(path, "r", mmap=False) as nc:
            var = nc.variables[_LUT_VAR]
            dims = tuple(var.dimensions)
            coords = {d: np.asarray(nc.variables[d][:]).copy() for d in dims
                      if d in nc.variables}
            attrs = {k: _decode(v) for k, v in nc._attributes.items()}
            data = np.asarray(var[:]).copy()
    return DimArray(data, dims=dims, coords=coords, attrs=attrs, name=_LUT_VAR)


def native_codec():
    """The native codec ``xsarsea_tpu_torch._lutio`` when it is built, else
    None (the callers then take their Python paths)."""
    try:
        from xsarsea_tpu_torch import _lutio
    except ImportError:
        return None
    return _lutio


def _packed_meta(lut: DimArray, attrs):
    return json.dumps({
        "dims": list(lut.dims),
        "coords": {d: np.asarray(lut.coords[d], np.float64).tolist() for d in lut.dims},
        "attrs": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in (attrs or {}).items()},
    })


def write_packed_lut(path, lut: DimArray, attrs=None):
    """Write a LUT in the packed XSTL1 cache format: magic, u32 JSON length,
    JSON (dims, float64 coords, attrs), u32 ndim, u64 shape, f32 C-order
    payload."""
    meta = _packed_meta(lut, lut.attrs if attrs is None else attrs)
    data = np.ascontiguousarray(lut.values, dtype=np.float32)
    _lutio = native_codec()
    if _lutio is not None:
        _lutio.write_packed(str(path), data, meta)
        return
    mb = meta.encode()
    with open(path, "wb") as f:
        f.write(_XSTL1)
        f.write(np.uint32(len(mb)).tobytes())
        f.write(mb)
        f.write(np.uint32(data.ndim).tobytes())
        f.write(np.asarray(data.shape, np.uint64).tobytes())
        f.write(data.tobytes())


def read_packed_lut(path) -> DimArray:
    """Read a packed XSTL1 LUT cache written by :func:`write_packed_lut`."""
    _lutio = native_codec()
    if _lutio is not None:
        data, meta = _lutio.read_packed(str(path))
        meta = json.loads(meta)
    else:
        with open(path, "rb") as f:
            if f.read(len(_XSTL1)) != _XSTL1:
                raise ValueError(f"{path}: not an XSTL1 file")
            mlen = int(np.frombuffer(f.read(4), np.uint32)[0])
            meta = json.loads(f.read(mlen))
            ndim = int(np.frombuffer(f.read(4), np.uint32)[0])
            shape = np.frombuffer(f.read(8 * ndim), np.uint64).astype(int)
            data = np.fromfile(f, np.float32).reshape(shape)
    return DimArray(data, dims=tuple(meta["dims"]),
                    coords={d: np.asarray(c) for d, c in meta["coords"].items()},
                    attrs=meta.get("attrs", {}), name=_LUT_VAR)
