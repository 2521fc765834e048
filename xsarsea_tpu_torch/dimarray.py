"""Labeled N-D array and dataset: counterpart of ``xsarsea_tpu.dimarray``.

The payload of a :class:`DimArray` is a numpy array, a ``torch.Tensor`` on
any device, or a chunked duck array (see :func:`is_chunked`), which the
constructor keeps lazy. Coordinates are host numpy arrays: they index the
data and never go to a device. Only the slice of xarray behaviour the SAR
ocean pipeline uses is implemented: named dims, 1-D coordinates, attrs,
``sel``/``isel``, separable linear ``interp``, broadcasting arithmetic by
dim name, reductions, ``coarsen_mean``, ``pad`` and friends. Every method
works on a numpy payload and on a tensor payload; a result has the kind of
payload that went in. :meth:`DimArray.to` and :meth:`DimArray.numpy` move a
payload between the host and a device.

The lerp in :meth:`DimArray._interp_1d` keeps the reference's exact
formula, ``data[i0] * (1 - w) + data[i1] * w``: high-resolution LUT values
are these lerps of the low-resolution analytic grid, so the formula is part
of LUT parity.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.utils.staging import to_device, to_host, torch_dtype

__all__ = ["DimArray", "DimDataset", "is_chunked", "blocked_coord_mean"]


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_chunked(obj):
    """True for dask/zarr-style lazy chunked arrays.

    The protocol the whole package keys out-of-core behaviour on: a
    ``.chunks`` attribute plus ``.ndim`` and numpy-style first-axis slicing,
    and not an in-memory numpy array or tensor. Used by DimArray's
    constructor, the xarray bridge, the streamed inversion source, lazy GMF
    evaluation and the detrend row streamer.
    """
    return (hasattr(obj, "chunks") and hasattr(obj, "ndim")
            and not isinstance(obj, (np.ndarray, torch.Tensor)))


def blocked_coord_mean(c, f=2):
    """Block-mean a 1-D coordinate: trim to a multiple of ``f``, average
    per block (the coordinate rule of :meth:`DimArray.coarsen_mean`)."""
    c = np.asarray(c, dtype=np.float64)
    n = (len(c) // f) * f
    return c[:n].reshape(-1, f).mean(axis=1)


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


def _like(x, ref):
    """``x`` as an operand for tensor ``ref``: arrays become tensors on its
    device, numpy scalars Python ones; anything else passes."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=ref.device)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _pair(a, b):
    """Two operands of one kind: when one is a tensor, the other follows."""
    if _is_tensor(a):
        return a, _like(b, a)
    if _is_tensor(b):
        return _like(a, b), b
    return a, b


_TORCH_REDUCTIONS = {"mean": torch.mean, "nanmean": torch.nanmean, "sum": torch.sum,
                     "min": torch.amin, "max": torch.amax}


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
        if not (_is_tensor(data) or isinstance(data, np.ndarray) or is_chunked(data)):
            # chunked duck arrays are stored as they are, so out-of-core
            # pipelines stay lazy; anything else is coerced
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

    # ---------------------------------------------------------------- basics
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self):
        """Host numpy copy of the data (a chunked payload is read whole)."""
        data = self.data
        if _is_tensor(data):
            return to_host(data)
        if is_chunked(data) and not hasattr(data, "__array__"):
            return np.asarray(data[0:data.shape[0]])
        return np.asarray(data)

    def item(self):
        return self.values.item()

    def __array__(self, dtype=None, copy=None):
        arr = self.values
        return arr.astype(dtype) if dtype is not None else arr

    def __getattr__(self, key):
        # coordinate access as attributes (xarray-style): lut.wspd, lut.phi.
        # Reached only when normal lookup failed; reads the slot through
        # object.__getattribute__ so an instance whose slots are not set yet
        # (during unpickling or copy.copy) raises AttributeError, not recurses.
        coords = object.__getattribute__(self, "coords")
        if key in coords:
            return coords[key]
        raise AttributeError(key)

    def __len__(self):
        return self.data.shape[0]

    def __repr__(self):
        coord_info = ", ".join(f"{k}: {len(v)}" for k, v in self.coords.items()
                               if k in self.dims)
        return (f"<DimArray {self.name or ''}{self.sizes} dtype={self.dtype} "
                f"coords=[{coord_info}]>")

    def copy(self, data=None):
        return DimArray(self.data if data is None else data, dims=self.dims,
                        coords=self.coords, attrs=self.attrs, name=self.name)

    def astype(self, dtype):
        """The payload cast to a numpy dtype (a tensor payload also takes a
        torch dtype)."""
        if _is_tensor(self.data):
            return self.copy(data=self.data.to(torch_dtype(dtype)))
        return self.copy(data=self.data.astype(dtype))

    def to(self, device):
        """The payload as a tensor on ``device`` (a numpy or chunked payload
        is copied there, the latter read whole)."""
        if _is_tensor(self.data):
            return self.copy(data=self.data.to(device))
        return self.copy(data=to_device(self.values, device))

    def numpy(self):
        """The payload as a host numpy array (the inverse of :meth:`to`)."""
        return self.copy(data=self.values)

    def rename(self, name=None, **dim_renames):
        dims = tuple(dim_renames.get(d, d) for d in self.dims)
        coords = {dim_renames.get(k, k): v for k, v in self.coords.items()}
        return DimArray(self.data, dims=dims, coords=coords, attrs=self.attrs,
                        name=name or self.name)

    def assign_coords(self, **coords):
        new = dict(self.coords)
        new.update({k: np.asarray(v) for k, v in coords.items()})
        return DimArray(self.data, dims=self.dims, coords=new, attrs=self.attrs,
                        name=self.name)

    def assign_attrs(self, **attrs):
        new = dict(self.attrs)
        new.update(attrs)
        return DimArray(self.data, dims=self.dims, coords=self.coords,
                        attrs=new, name=self.name)

    def drop_coords(self, *names):
        coords = {k: v for k, v in self.coords.items() if k not in names}
        return DimArray(self.data, dims=self.dims, coords=coords, attrs=self.attrs,
                        name=self.name)

    # ------------------------------------------------------------- selection
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

    def sel(self, indexers=None, method=None, **kwargs):
        """Select by coordinate value. method='nearest' supported; exact otherwise."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        iidx = {}
        for dim, val in indexers.items():
            coord = self.coords[dim]
            val_arr = np.atleast_1d(np.asarray(val))
            if method == "nearest":
                pos = np.abs(coord[None, :] - val_arr[:, None]).argmin(axis=1)
            else:
                sorter = np.argsort(coord)
                # searchsorted returns len(coord) for values above the
                # maximum: clip, so the allclose guard below raises the
                # contractual KeyError instead of an IndexError
                ins = np.clip(np.searchsorted(coord, val_arr, sorter=sorter),
                              0, len(coord) - 1)
                pos = sorter[ins]
                if not np.allclose(coord[pos], val_arr):
                    raise KeyError(f"values {val} not found in coord '{dim}'")
            iidx[dim] = int(pos[0]) if np.ndim(val) == 0 else pos
        return self.isel(iidx)

    def squeeze(self, dim=None):
        if dim is None:
            idx = {d: 0 for d, s in self.sizes.items() if s == 1}
        else:
            if self.sizes[dim] != 1:
                raise ValueError(f"cannot squeeze dim '{dim}' of size {self.sizes[dim]}")
            idx = {dim: 0}
        return self.isel(idx)

    def expand_dims(self, dim, axis=0):
        if isinstance(dim, (list, tuple)):
            out = self
            for d in reversed(dim):
                out = out.expand_dims(d, axis=axis)
            return out
        data = self.data.unsqueeze(axis) if _is_tensor(self.data) \
            else np.expand_dims(self.data, axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return DimArray(data, dims=dims, coords=self.coords, attrs=self.attrs, name=self.name)

    def transpose(self, *dims):
        """Reorder the dims (reversed when none are given)."""
        dims = dims or self.dims[::-1]
        axes = [self._axis(d) for d in dims]
        data = self.data.permute(axes) if _is_tensor(self.data) else self.data.transpose(axes)
        return DimArray(data, dims=dims, coords=self.coords, attrs=self.attrs, name=self.name)

    # ---------------------------------------------------------------- interp
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

    # ------------------------------------------------------------ reductions
    def _reduce(self, op, dim=None):
        """Reduce with numpy's or torch's ``op`` over all of the data (a
        scalar comes back) or over the named dim(s)."""
        tensor = _is_tensor(self.data)
        data = self.data
        if tensor and op in ("mean", "nanmean") \
                and not (data.is_floating_point() or data.is_complex()):
            data = data.to(torch.get_default_dtype())
        fn = _TORCH_REDUCTIONS[op] if tensor else getattr(np, op)
        if dim is None:
            if tensor and op in ("min", "max"):  # amin/amax need their dims named
                return fn(data, dim=tuple(range(data.ndim)))
            return fn(data)
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self._axis(d) for d in dims)
        data = fn(data, dim=axes) if tensor else fn(data, axis=axes)
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {k: v for k, v in self.coords.items() if k not in dims}
        return DimArray(data, dims=new_dims, coords=coords, attrs=self.attrs, name=self.name)

    def mean(self, dim=None):
        return self._reduce("mean", dim)

    def nanmean(self, dim=None):
        return self._reduce("nanmean", dim)

    def sum(self, dim=None):
        return self._reduce("sum", dim)

    def min(self, dim=None):
        return self._reduce("min", dim)

    def max(self, dim=None):
        return self._reduce("max", dim)

    def argmax(self, dim):
        ax = self._axis(dim)
        data = torch.argmax(self.data, dim=ax) if _is_tensor(self.data) \
            else np.argmax(self.data, axis=ax)
        new_dims = tuple(d for d in self.dims if d != dim)
        coords = {k: v for k, v in self.coords.items() if k != dim}
        return DimArray(data, dims=new_dims, coords=coords, attrs=self.attrs, name=self.name)

    def coarsen_mean(self, factors, boundary="trim"):
        """Block-mean coarsening, like ``xr.coarsen(...).mean()`` with trim:
        trailing rows and columns that do not fill a block are trimmed, and
        coords are averaged per block."""
        if boundary != "trim":
            raise NotImplementedError("only boundary='trim'")
        tensor = _is_tensor(self.data)
        data = self.data
        coords = dict(self.coords)
        for dim, f in factors.items():
            if f == 1:
                continue
            ax = self._axis(dim)
            n = (data.shape[ax] // f) * f
            data = _index(data, ax, slice(0, n))
            new_shape = tuple(data.shape[:ax]) + (n // f, f) + tuple(data.shape[ax + 1:])
            blocks = data.reshape(new_shape)
            data = blocks.mean(dim=ax + 1) if tensor else np.mean(blocks, axis=ax + 1)
            if dim in coords:
                coords[dim] = blocked_coord_mean(coords[dim], f)
        return DimArray(data, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)

    def pad(self, pad_widths, mode="wrap"):
        """Pad along named dims with one of ``np.pad``'s modes.
        ``pad_widths``: {dim: int or (before, after)}."""
        widths = []
        for d in self.dims:
            w = pad_widths.get(d, 0)
            widths.append((w, w) if isinstance(w, int) else tuple(w))
        if _is_tensor(self.data):
            data = self.data
            if mode == "constant":
                flat = [w for pair in reversed(widths) for w in pair]
                data = torch.nn.functional.pad(data, flat)
            else:
                # the index modes (wrap, reflect, symmetric, edge): pad each
                # axis's positions with numpy's rule, then gather
                for ax, w in enumerate(widths):
                    if w != (0, 0):
                        data = _index(data, ax, np.pad(np.arange(data.shape[ax]), w, mode=mode))
        else:
            data = np.pad(self.data, widths, mode=mode)
        coords = {k: v for k, v in self.coords.items()
                  if k not in pad_widths or (np.asarray(pad_widths[k]) == 0).all()}
        return DimArray(data, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)

    # ----------------------------------------------------------- arithmetic
    def broadcast_like(self, other):
        """Broadcast to the dims/shape of `other` (dims must be a subset)."""
        out = self
        for d in other.dims:
            if d not in self.dims:
                out = out.expand_dims(d, axis=0)
        out = out.transpose(*other.dims)
        data = out.data
        if _is_tensor(other.data) and not _is_tensor(data):
            data = torch.as_tensor(data, device=other.data.device)
        data = data.expand(other.shape) if _is_tensor(data) \
            else np.broadcast_to(data, other.shape)
        coords = dict(other.coords)
        coords.update({k: v for k, v in self.coords.items() if k not in other.dims})
        return DimArray(data, dims=other.dims, coords=coords, attrs=self.attrs, name=self.name)

    def _binary(self, other, fn):
        if isinstance(other, DimArray):
            a, b, dims, coords = _align(self, other)
            return DimArray(fn(*_pair(a, b)), dims=dims, coords=coords, attrs={},
                            name=self.name)
        return DimArray(fn(*_pair(self.data, other)), dims=self.dims, coords=self.coords,
                        attrs={}, name=self.name)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binary(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: b / a)

    def __mod__(self, other):
        return self._binary(other, lambda a, b: a % b)

    def __pow__(self, other):
        return self._binary(other, lambda a, b: a ** b)

    def __rpow__(self, other):
        return self._binary(other, lambda a, b: b ** a)

    def __neg__(self):
        return self.copy(data=-self.data)

    def __abs__(self):
        return self.copy(data=abs(self.data))

    def __lt__(self, other):
        return self._binary(other, lambda a, b: a < b)

    def __le__(self, other):
        return self._binary(other, lambda a, b: a <= b)

    def __gt__(self, other):
        return self._binary(other, lambda a, b: a > b)

    def __ge__(self, other):
        return self._binary(other, lambda a, b: a >= b)

    # elementwise like the other comparisons (and xarray): without these,
    # ``da == flag`` silently degrades to identity comparison
    def __eq__(self, other):
        return self._binary(other, lambda a, b: a == b)

    def __ne__(self, other):
        return self._binary(other, lambda a, b: a != b)

    __hash__ = None  # elementwise __eq__ makes instances unhashable

    def _conform(self, arr):
        """Raw data of ``arr`` laid out to this array's dim order.

        A DimArray whose dims are a permutation of (a suffix of) ours is
        transposed by name first: a positional ``where`` or broadcast on a
        transposed mask of the same size would silently hit the wrong pixels.
        """
        if not isinstance(arr, DimArray):
            return arr
        if arr.dims != self.dims and set(arr.dims) <= set(self.dims):
            order = tuple(d for d in self.dims if d in arr.dims)
            if order != arr.dims:
                arr = arr.transpose(*order)
        return arr.data

    def _where(self, mask, kept, other):
        """``where(mask, kept, other)`` in the kind of this array's payload."""
        if _is_tensor(self.data):
            return torch.where(_like(mask, self.data), _like(kept, self.data),
                               _like(other, self.data))
        return np.where(mask, kept, other)

    def where(self, cond, other=np.nan):
        return self.copy(data=self._where(self._conform(cond), self.data,
                                          self._conform(other)))

    def fillna(self, value):
        isnan = torch.isnan if _is_tensor(self.data) else np.isnan
        return self.copy(data=self._where(isnan(self.data), value, self.data))

    def coord_spacing(self, dim):
        """Spacing of a dim's coordinate (its first step; 1.0 for a single point)."""
        d = np.diff(np.asarray(self.coords[dim], dtype=np.float64))
        return float(d[0]) if len(d) else 1.0


class DimDataset:
    """Minimal named collection of DimArrays sharing coordinates.

    Stands in for the ``xarray.Dataset`` objects the reference gradients
    pipeline returns: variable access by key or attribute, shared
    isel/sel, concat along a new or existing dim.
    """

    def __init__(self, variables=None, attrs=None):
        self.variables = dict(variables or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, key):
        return self.variables[key]

    def __setitem__(self, key, value):
        self.variables[key] = value

    def __contains__(self, key):
        return key in self.variables

    def __getattr__(self, key):
        variables = object.__getattribute__(self, "variables")
        if key in variables:
            return variables[key]
        raise AttributeError(key)

    def __repr__(self):
        return f"<DimDataset vars={list(self.variables)}>"

    @property
    def dims(self):
        out = {}
        for v in self.variables.values():
            out.update(v.sizes)
        return out

    def _map(self, fn):
        return DimDataset({k: fn(v) for k, v in self.variables.items()}, attrs=self.attrs)

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        return self._map(lambda v: v.isel({d: i for d, i in indexers.items() if d in v.dims}))

    def sel(self, indexers=None, method=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        for k, v in self.variables.items():
            bad = [d for d in indexers if d in v.dims and d not in v.coords]
            if bad:
                # silently skipping would leave this variable full-length
                # while others shrink: inconsistent sizes along the dim
                raise KeyError(
                    f"cannot label-select dim(s) {bad} on variable '{k}': "
                    "it has the dim but no coordinate (use isel)")
        return self._map(lambda v: v.sel({d: i for d, i in indexers.items() if d in v.coords},
                                         method=method))

    def interp(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        return self._map(lambda v: v.interp({d: i for d, i in indexers.items()
                                             if d in v.dims}))

    def expand_dims(self, dims):
        return self._map(lambda v: v.expand_dims(dims))

    def assign_coords(self, **coords):
        return self._map(lambda v: v.assign_coords(**coords))

    def mean(self, dim):
        dims = dim if isinstance(dim, (list, tuple)) else [dim]

        def one(v):
            present = [d for d in dims if d in v.dims]
            return v.mean(dim=present) if present else v

        return self._map(one)

    @staticmethod
    def concat(datasets, dim):
        """Concatenate datasets along ``dim`` (like ``xr.concat``).

        A dim already present in the variables concatenates along that
        axis (coords for it are concatenated too); a new dim stacks it
        in front.
        """
        out = {}
        for k in datasets[0].variables:
            arrs = [ds[k] for ds in datasets]
            first = arrs[0]
            tensor = _is_tensor(first.data)
            payloads = [_like(a.data, first.data) if tensor else np.asarray(a.data)
                        for a in arrs]
            if dim in first.dims:
                ax = first.dims.index(dim)
                data = torch.cat(payloads, dim=ax) if tensor \
                    else np.concatenate(payloads, axis=ax)
                coords = dict(first.coords)
                if dim in coords:
                    coords[dim] = np.concatenate([np.asarray(a.coords[dim]) for a in arrs])
                out[k] = DimArray(data, dims=first.dims, coords=coords,
                                  attrs=first.attrs, name=first.name)
            else:
                data = torch.stack(payloads, dim=0) if tensor else np.stack(payloads, axis=0)
                out[k] = DimArray(data, dims=(dim,) + first.dims, coords=first.coords,
                                  attrs=first.attrs, name=first.name)
        return DimDataset(out, attrs=datasets[0].attrs)


def _align(a: DimArray, b: DimArray):
    """Broadcast two DimArrays xarray-style: union of dims, by name."""
    dims = list(a.dims) + [d for d in b.dims if d not in a.dims]

    def reshaped(x):
        x = x.transpose(*[d for d in dims if d in x.dims])
        return x.data.reshape([x.sizes[d] if d in x.dims else 1 for d in dims])

    coords = dict(b.coords)
    coords.update(a.coords)
    return reshaped(a), reshaped(b), tuple(dims), coords
