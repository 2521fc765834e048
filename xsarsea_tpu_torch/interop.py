"""xarray interop: accept and return ``xr.DataArray`` at public entry points
(counterpart of ``xsarsea_tpu.interop``).

The reference library's entire surface consumes and produces
``xarray.DataArray`` (reference windspeed/windspeed.py:17-124,
models.py:82-174, detrend.py:8-68). This package's native container is
:class:`~xsarsea_tpu_torch.dimarray.DimArray`; this module bridges the two
so a reference user can feed their DataArrays straight into
``invert_from_model``, ``sigma0_detrend``, ``nesz_flattening`` and
``get_dsig``/``get_dsig_wspd`` and get DataArrays back with matching
dims/coords/attrs. A tensor payload lands in the caller's DataArray as a
host numpy array.

xarray stays an *optional* dependency: detection and conversion are
duck-typed against the DataArray protocol (``dims``/``coords``/``values``/
``attrs``), and the output is rebuilt with the *input's own class* — no
``import xarray`` anywhere, so the module imports and is testable in
environments without xarray installed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray, is_chunked

__all__ = ["is_dataarray_like", "to_dimarray", "to_dataarray", "to_dataset", "xarray_io"]


def is_dataarray_like(obj):
    """True for xr.DataArray-shaped objects (and not our own DimArray).

    ``values`` is looked up on the class (or the instance's ``__dict__``),
    never read: on a chunked DataArray reading it computes the whole scene.
    """
    return (
        not isinstance(obj, (DimArray, np.ndarray, torch.Tensor))
        and hasattr(obj, "dims")
        and hasattr(obj, "coords")
        and hasattr(obj, "attrs")
        and (hasattr(type(obj), "values") or "values" in getattr(obj, "__dict__", ()))
        and isinstance(getattr(obj, "dims", None), tuple)
    )


def _coord_values(c):
    return np.asarray(getattr(c, "values", c))


def to_dimarray(da) -> DimArray:
    """Convert an xr.DataArray(-like) into a DimArray.

    Keeps 1-D coords indexing a dim plus scalar (0-d) coords such as
    ``pol``; 2-D auxiliary coords (lat/lon rasters) are dropped — the
    pipeline never consumes them and they are restored from the template
    on the way back out.
    """
    dims = tuple(da.dims)
    # chunked (dask-backed) DataArrays keep their lazy array: ``.values``
    # would materialize the whole scene, defeating out-of-core execution
    # (reference dask path: windspeed.py:345-367).
    data = getattr(da, "data", None)
    if not is_chunked(data):
        data = np.asarray(da.values)
    shape = tuple(np.shape(data))
    coords = {}
    for k in da.coords:
        v = _coord_values(da.coords[k])
        if v.ndim == 0:
            coords[k] = v
        elif v.ndim == 1 and (k not in dims or v.shape[0] == shape[dims.index(k)]):
            coords[k] = v
    return DimArray(
        data,
        dims=dims,
        coords=coords,
        attrs=dict(da.attrs),
        name=getattr(da, "name", None),
    )


def to_dataarray(arr: DimArray, da_cls, template=None):
    """Rebuild a DataArray of class ``da_cls`` from a DimArray.

    ``da_cls`` is the class of an input DataArray (so the constructor
    contract is xr.DataArray's: ``cls(data, coords=..., dims=...,
    name=..., attrs=...)``). When ``template`` (the original input
    DataArray) is given, its auxiliary coords that the DimArray round
    trip dropped — 2-D lat/lon rasters in particular — are re-attached
    best-effort (only where dims/shapes still line up).
    """
    coords = {}
    for k, v in arr.coords.items():
        v = np.asarray(v)
        if v.ndim == 0:
            coords[k] = v.item() if v.dtype.kind in "US" else v[()]
        elif k in arr.dims:
            coords[k] = v
        elif v.ndim == 1 and v.shape[0] == 1:
            coords[k] = v[0]
    # chunked payloads (dask et al) pass through UNMATERIALIZED — the
    # reference's whole surface is lazy xarray; np.asarray here would
    # compute a scene-sized array at the boundary. xr.DataArray holds
    # duck arrays natively. Everything else (tensor/numpy) lands as numpy.
    data = arr.data if is_chunked(arr.data) else arr.values
    out = da_cls(
        data,
        coords=coords,
        dims=arr.dims,
        name=arr.name,
    )
    out.attrs.update(arr.attrs)
    if template is not None:
        for k in template.coords:
            if k in coords:
                continue
            try:
                out.coords[k] = template.coords[k]
            except Exception:  # noqa: BLE001 — dims/shape no longer line up
                pass
    return out


def to_dataset(variables: dict, da_cls):
    """Build an ``xr.Dataset`` of DataArrays from a dict of DimArrays.

    The Dataset class is looked up in the top-level module of ``da_cls``
    (``xarray`` for real DataArrays). Returns None when no Dataset class
    is available — callers fall back to their native container.
    """
    import importlib

    try:
        mod = importlib.import_module(da_cls.__module__.split(".")[0])
        ds_cls = getattr(mod, "Dataset")
    except Exception:  # noqa: BLE001 — interop is best-effort
        return None
    return ds_cls({k: to_dataarray(v, da_cls) for k, v in variables.items()})


def xarray_io(fn):
    """Decorator: convert DataArray args to DimArray, and DimArray results
    back to the caller's DataArray class when any input was a DataArray."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        template = [None]

        def conv(v):
            if is_dataarray_like(v):
                if template[0] is None:
                    template[0] = v
                return to_dimarray(v)
            return v

        args = tuple(conv(a) for a in args)
        kwargs = {k: conv(v) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        if template[0] is None:
            return out

        def back(o):
            if isinstance(o, DimArray):
                return to_dataarray(o, type(template[0]),
                                    template=template[0])
            return o

        if isinstance(out, tuple):
            return tuple(back(o) for o in out)
        return back(out)

    return wrapper
