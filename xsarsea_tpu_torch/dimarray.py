"""Labeled N-D array: the slice of ``xsarsea_tpu.dimarray.DimArray`` LUTs need.

The payload is a numpy array or a ``torch.Tensor``; coordinates are host
numpy arrays. Ported: dims/coords/attrs/name, ``copy``, ``assign_attrs``,
``item``, ``isel``, ``transpose`` and separable linear ``interp``. The lerp in :meth:`_interp_1d`
keeps the reference's exact formula, ``data[i0] * (1 - w) + data[i1] * w``:
high-resolution LUT values are these lerps of the low-resolution analytic
grid, so the formula is part of LUT parity.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DimArray"]


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def _index(data, ax, idx):
    """``data[..., idx, ...]`` on axis ``ax`` for numpy and torch payloads."""
    if _is_tensor(data):
        if isinstance(idx, slice) and idx.step is not None and idx.step < 0:
            start, stop, step = idx.indices(data.shape[ax])
            pos = torch.arange(start, stop, step, device=data.device)
            return data.index_select(ax, pos)
        if isinstance(idx, np.ndarray):
            return data.index_select(ax, torch.as_tensor(idx, device=data.device))
    sl = [slice(None)] * data.ndim
    sl[ax] = idx
    return data[tuple(sl)]


class DimArray:
    """N-D array with named dims, 1-D coords and attrs."""

    __slots__ = ("data", "dims", "coords", "attrs", "name")

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        if isinstance(data, DimArray):
            dims = dims or data.dims
            coords = coords if coords is not None else data.coords
            attrs = attrs if attrs is not None else data.attrs
            name = name or data.name
            data = data.data
        if not (_is_tensor(data) or isinstance(data, np.ndarray)):
            data = np.asarray(data)
        ndim = data.ndim
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(ndim))
        dims = tuple(dims)
        if len(dims) != ndim:
            raise ValueError(f"dims {dims} do not match data ndim {ndim}")
        self.data = data
        self.dims = dims
        self.coords = {}
        for k, v in (coords or {}).items():
            v = np.asarray(v)
            if k in dims:
                ax = dims.index(k)
                if v.ndim != 1 or v.shape[0] != data.shape[ax]:
                    raise ValueError(
                        f"coord '{k}' of shape {v.shape} does not match dim size "
                        f"{data.shape[ax]}")
            self.coords[k] = v
        self.attrs = dict(attrs) if attrs else {}
        self.name = name

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self):
        """Host numpy copy of the data."""
        return np.asarray(self.data.cpu() if _is_tensor(self.data) else self.data)

    def item(self):
        return self.values.item()

    def __array__(self, dtype=None, copy=None):
        arr = self.values
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        coord_info = ", ".join(f"{k}: {len(v)}" for k, v in self.coords.items()
                               if k in self.dims)
        return (f"<DimArray {self.name or ''}{self.sizes} dtype={self.dtype} "
                f"coords=[{coord_info}]>")

    def copy(self, data=None):
        return DimArray(self.data if data is None else data, dims=self.dims,
                        coords=self.coords, attrs=self.attrs, name=self.name)

    def assign_attrs(self, **attrs):
        new = dict(self.attrs)
        new.update(attrs)
        return DimArray(self.data, dims=self.dims, coords=self.coords,
                        attrs=new, name=self.name)

    def _axis(self, dim):
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"dim '{dim}' not in {self.dims}") from None

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        data = self.data
        dims = list(self.dims)
        coords = dict(self.coords)
        # apply in reverse-axis order so axis numbers stay valid on drops
        for dim, idx in sorted(indexers.items(), key=lambda kv: -self._axis(kv[0])):
            ax = dims.index(dim)
            data = _index(data, ax, idx)
            if isinstance(idx, (int, np.integer)):
                dims.pop(ax)
                if dim in coords:
                    coords[dim] = np.asarray(coords[dim][idx])
            elif dim in coords:
                coords[dim] = coords[dim][idx]
        return DimArray(data, dims=dims, coords=coords, attrs=self.attrs, name=self.name)

    def transpose(self, *dims):
        """Reorder the dims (reversed when none are given)."""
        dims = dims or self.dims[::-1]
        axes = [self._axis(d) for d in dims]
        data = self.data.permute(axes) if _is_tensor(self.data) else self.data.transpose(axes)
        return DimArray(data, dims=dims, coords=self.coords, attrs=self.attrs, name=self.name)

    def interp(self, indexers=None, bounds_error=False, **kwargs):
        """Separable multilinear interpolation onto new 1-D coords per dim.

        Out-of-range points yield NaN unless ``bounds_error=True``, in which
        case a ValueError is raised.
        """
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        out = self
        for dim, new_c in indexers.items():
            out = out._interp_1d(dim, np.asarray(new_c, dtype=np.float64), bounds_error)
        return out

    def _interp_1d(self, dim, new_c, bounds_error):
        ax = self._axis(dim)
        old_c = np.asarray(self.coords[dim], dtype=np.float64)
        if len(old_c) > 1 and old_c[0] > old_c[-1]:
            # descending coordinate: flip to ascending before searchsorted
            flipped = self.isel({dim: slice(None, None, -1)})
            return flipped._interp_1d(dim, new_c, bounds_error)
        if new_c.ndim == 1 and np.array_equal(old_c, new_c):
            # identity re-grid: no lerp (also avoids 0*NaN from NaN neighbours)
            coords = dict(self.coords)
            coords[dim] = new_c
            return DimArray(self.data, dims=self.dims, coords=coords,
                            attrs=self.attrs, name=self.name)
        if bounds_error and (new_c.min() < old_c.min() - 1e-12
                             or new_c.max() > old_c.max() + 1e-12):
            raise ValueError(f"interp out of bounds on dim '{dim}'")
        scalar = new_c.ndim == 0
        new_c = np.atleast_1d(new_c)
        i1 = np.clip(np.searchsorted(old_c, new_c), 1, len(old_c) - 1)
        i0 = i1 - 1
        denom = old_c[i1] - old_c[i0]
        w = (new_c - old_c[i0]) / np.where(denom == 0, 1.0, denom)
        oob = (new_c < old_c[0]) | (new_c > old_c[-1])

        if _is_tensor(self.data):
            data = torch.movedim(self.data, ax, 0)
            if not (data.is_floating_point() or data.is_complex()):
                data = data.to(torch.float32)
            shape = (-1,) + (1,) * (data.ndim - 1)
            w_b = torch.as_tensor(w).reshape(shape).to(data.dtype).to(data.device)
            i0_t = torch.as_tensor(i0, device=data.device)
            i1_t = torch.as_tensor(i1, device=data.device)
            res = data[i0_t] * (1 - w_b) + data[i1_t] * w_b
            if oob.any():
                mask = torch.as_tensor(oob, device=data.device).reshape(shape)
                res = torch.where(mask, torch.full_like(res, float("nan")), res)
            res = torch.movedim(res, 0, ax)
        else:
            data = np.moveaxis(self.data, ax, 0)
            if not (np.issubdtype(data.dtype, np.floating)
                    or np.issubdtype(data.dtype, np.complexfloating)):
                # integer/bool data: promote (like xarray) — casting the lerp
                # weights to the data dtype would truncate them all to 0
                data = data.astype(np.float64)
            shape = (-1,) + (1,) * (data.ndim - 1)
            w_b = np.asarray(w).reshape(shape).astype(data.dtype)
            res = data[i0] * (1 - w_b) + data[i1] * w_b
            if oob.any():
                res = np.where(oob.reshape(shape), np.asarray(np.nan, dtype=res.dtype), res)
            res = np.moveaxis(res, 0, ax)
        coords = dict(self.coords)
        coords[dim] = new_c
        out = DimArray(res, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)
        if scalar:
            out = out.isel({dim: 0})
        return out
