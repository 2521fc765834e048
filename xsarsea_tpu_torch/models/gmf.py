"""GmfModel: analytic GMFs as broadcasting torch functions.

Counterpart of ``xsarsea_tpu.models.gmf``. A registered GMF is a plain
function of tensors ``f(inc, wspd[, phi])`` that broadcasts, so one code
path serves scalar calls, N-D evaluation and 3-D LUT generation.

Precision follows the inputs: tensor inputs keep their floating dtype and
device; numpy arrays and Python numbers evaluate in float64 on the CPU.
A broadcast evaluation with a chunked input (``is_chunked``) stays lazy: it
returns a :class:`_LazyGmfEval`, evaluated block by block on demand.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray, is_chunked
from xsarsea_tpu_torch.models.base import Model, _grid
from xsarsea_tpu_torch.utils import to_device, to_host

logger = logging.getLogger("xsarsea_tpu_torch.models.gmf")

__all__ = ["GmfModel"]


def _raw(v):
    return v.data if isinstance(v, DimArray) else v


def _common_kind(values):
    """(dtype, device) for a call: the first floating tensor input's, else
    float64 on the CPU."""
    for v in values:
        v = _raw(v)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.dtype, v.device
    return torch.float64, torch.device("cpu")


def _prep(v, dtype, device):
    if v is None:
        return None
    v = _raw(v)
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=device)


class _LazyGmfEval:
    """Lazy block-evaluated GMF result over chunked broadcast inputs.

    The reference library keeps direct GMF evaluation on dask inputs lazy
    (``da.broadcast_arrays`` and a ufunc, gmfs.py:293-316). Here the result
    is a duck chunked array: it satisfies the package's lazy protocol
    (``shape``/``ndim``/``dtype``/``chunks`` and numpy-style first-axis
    slicing, see ``is_chunked``) and evaluates the GMF on a block of rows,
    on the call's device, only when that block is asked for. A block comes
    back as a host numpy array. The whole result exists only if the caller
    asks for it (``np.asarray``); streaming consumers (the inversion source,
    detrend) pull it piece by piece.
    """

    _BLOCK_ELEMS = 1 << 22

    def __init__(self, eval_fn, raws, shape, dtype, device):
        self._eval_fn = eval_fn  # broadcast evaluation over prepared tensors
        self._raws = raws  # (inc, wspd, phi) raw data objects (phi may be None)
        self._kind = dict(dtype=dtype, device=device)
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.dtype = torch.empty(0, dtype=dtype).numpy().dtype
        self._small = {}  # chunked inputs smaller than the result, read once
        row = int(np.prod(self.shape[1:], dtype=np.int64))
        rows = max(1, self._BLOCK_ELEMS // max(row, 1))
        n0 = self.shape[0] if self.shape else 1
        self.chunks = (tuple(min(rows, n0 - lo) for lo in range(0, n0, rows)),) \
            + tuple((s,) for s in self.shape[1:])

    def _block(self, raw, lo, hi):
        if raw is None:
            return None
        if isinstance(raw, torch.Tensor):
            return raw.expand(self.shape)[lo:hi].to(**self._kind)
        if is_chunked(raw) and tuple(raw.shape) == self.shape:
            raw = np.asarray(raw[lo:hi])
        else:
            if is_chunked(raw):  # the small operand of a broadcast: read it once
                if id(raw) not in self._small:
                    # the lazy protocol guarantees first-axis slicing only
                    self._small[id(raw)] = np.asarray(raw[0:raw.shape[0]])
                raw = self._small[id(raw)]
            raw = np.array(np.broadcast_to(np.asarray(raw), self.shape)[lo:hi])  # a copy
        return to_device(raw, self._kind["device"], self._kind["dtype"])

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if not (idx and isinstance(idx[0], slice) and all(s == slice(None) for s in idx[1:])):
            raise IndexError("lazy GMF result supports first-axis slicing only; "
                             "np.asarray() it for random access")
        lo, hi, step = idx[0].indices(self.shape[0])
        if step != 1:
            raise IndexError("lazy GMF result does not support strided slices")
        out = self._eval_fn(*(self._block(r, lo, hi) for r in self._raws))
        return to_host(out)

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, dtype=self.dtype)
        lo = 0
        for rows in self.chunks[0]:
            out[lo:lo + rows] = self[lo:lo + rows]
            lo += rows
        return out if dtype is None else out.astype(dtype)


class GmfModel(Model):
    """Model backed by an analytic torch function ``f(inc, wspd, phi)``."""

    _name_prefix = "gmf_"
    _priority = 3
    _deferred = []

    @classmethod
    def register(cls, name=None, pol=None, units="linear", defer=True, **kwargs):
        """Decorator registering a GMF function (reference gmfs.py:23-105).

        The decorated function takes tensors and broadcasts over its
        (inc, wspd[, phi]) arguments.
        """

        def inner(func):
            gmf_name = name or func.__name__
            if not gmf_name.startswith(cls._name_prefix):
                raise ValueError(f"gmf function name must start with '{cls._name_prefix}'")
            wspd_range = kwargs.pop("wspd_range", None)
            if wspd_range is None:
                wspd_range = [0.2, 50.0] if len(set(pol)) == 1 else [3.0, 80.0]
            if defer:
                cls._deferred.append((func, gmf_name, wspd_range, pol, units, dict(kwargs)))
            else:
                cls.register_function(func, gmf_name, wspd_range=wspd_range, pol=pol,
                                      units=units, **kwargs)
            return func

        return inner

    @classmethod
    def register_function(cls, func, name, wspd_range=None, pol=None, units="linear", **kwargs):
        """Immediately register `func` under `name`. Idempotent re-registration."""
        return cls(name, func, wspd_range=wspd_range, pol=pol, units=units, **kwargs)

    @classmethod
    def activate_gmfs_impl(cls, gmfs_names=None, **kwargs):
        """Process deferred registrations (reference gmfs.py:112-125)."""
        for func, name, wspd_range, pol, units, reg_kwargs in cls._deferred:
            if gmfs_names is None or name in gmfs_names:
                cls.register_function(func, name, wspd_range=wspd_range, pol=pol,
                                      units=units, **{**reg_kwargs, **kwargs})

    def __init__(self, name, gmf_fn, wspd_range=None, pol=None, units=None, **kwargs):
        # probe: does the function require phi, and with what period?
        # (reference gmfs.py:134-158)
        phi_range = kwargs.pop("phi_range", None)
        try:
            np.asarray(gmf_fn(35.0, 0.2, None), dtype=np.float64)
            needs_phi = False
        except (TypeError, ValueError):
            needs_phi = True

        if phi_range is None and needs_phi:
            # a phi-periodic-180 GMF is symmetric under phi -> -phi; require
            # symmetry at every probed quadrant (max, not the reference's
            # min, so an asymmetric user GMF registers as [0, 360])
            probe = np.array([0.0, 90.0, 180.0, 270.0])
            diff = np.abs(np.asarray(gmf_fn(35.0, 0.2, probe))
                          - np.asarray(gmf_fn(35.0, 0.2, -probe)))
            phi_range = [0.0, 180.0] if diff.max() < 1e-15 else [0.0, 360.0]
        elif not needs_phi:
            phi_range = None

        super().__init__(name, units=units, pol=pol, wspd_range=wspd_range or [0.2, 50.0],
                         phi_range=phi_range, **kwargs)
        self._gmf_fn = gmf_fn
        self._needs_phi = needs_phi

    def _eval_broadcast(self, inc, wspd, phi):
        if self._needs_phi:
            return self._gmf_fn(inc, wspd, phi)
        return self._gmf_fn(inc, wspd)

    def _eval_grid(self, inc, wspd, phi):
        """Outer-product grid evaluation -> shape (inc, wspd[, phi])."""
        if self._needs_phi:
            return self._gmf_fn(inc[:, None, None], wspd[None, :, None], phi[None, None, :])
        return self._gmf_fn(inc[:, None], wspd[None, :])

    def __call__(self, inc, wspd, phi=None, broadcast=False):
        """Evaluate the GMF (dispatch as reference gmfs.py:266-348).

        All-scalar -> float; all-1D -> outer-product DimArray over
        (incidence, wspd[, phi]); otherwise, or with ``broadcast=True``,
        elementwise broadcast evaluation returning a tensor (or a DimArray
        when an input is one); with a chunked input that evaluation is lazy
        (:class:`_LazyGmfEval`).
        """
        if self._needs_phi and phi is None:
            raise ValueError(
                f"model {self.name} ({self.pol}) requires a phi argument "
                "(wind direction relative to antenna, degrees)")
        vals = [v for v in (inc, wspd, phi) if v is not None]
        all_scalar = all(np.isscalar(v) for v in vals)
        all_1d = all(hasattr(v, "ndim") and v.ndim == 1 for v in vals)
        if any(hasattr(v, "ndim") and v.ndim > 1 for v in vals):
            broadcast = True
        dtype, device = _common_kind(vals)
        template = next((v for v in (inc, wspd, phi) if isinstance(v, DimArray)), None)

        if broadcast and any(is_chunked(_raw(v)) for v in vals):
            # chunked inputs stay lazy: evaluated block by block on demand.
            # The shape broadcasts over all the inputs given, phi included
            # for a phi-independent model, as the eager branch below does.
            raws = [_raw(inc), _raw(wspd), _raw(phi) if self._needs_phi else None]
            shape = np.broadcast_shapes(*(tuple(np.shape(_raw(v))) for v in vals))
            out = _LazyGmfEval(self._eval_broadcast, tuple(raws), shape, dtype, device)
            if template is not None:
                res = template.copy(data=out)
                res.attrs = {"units": self.units}
                return res
            return out

        phi_t = _prep(phi, dtype, device) if self._needs_phi else None

        if broadcast:
            out = self._eval_broadcast(_prep(inc, dtype, device), _prep(wspd, dtype, device),
                                       phi_t)
            out = out.expand(torch.broadcast_shapes(*(tuple(np.shape(_raw(v))) for v in vals)))
            if template is not None:
                res = template.copy(data=out)
                res.attrs = {"units": self.units}
                return res
            return out

        if all_scalar:
            return float(self._eval_broadcast(_prep(inc, dtype, device),
                                              _prep(wspd, dtype, device), phi_t))

        if all_1d:
            data = self._eval_grid(_prep(inc, dtype, device), _prep(wspd, dtype, device), phi_t)
            dims = ["incidence", "wspd"]
            coords = {"incidence": np.asarray(_raw(inc)), "wspd": np.asarray(_raw(wspd))}
            if self._needs_phi:
                dims.append("phi")
                coords["phi"] = np.asarray(_raw(phi))
            return DimArray(data, dims=dims, coords=coords, attrs={"units": self.units},
                            name="sigma0_gmf")

        raise ValueError("inputs must be all-scalar, all-1D, or broadcastable N-D")

    def _raw_lut(self, resolution="low", **kwargs):
        """Generate the LUT on the host over linspace grids (gmfs.py:350-395).

        Low resolution by default; ``Model.to_lut`` then up-interpolates to
        the requested resolution, so high-res LUT values are linear interps
        of the low-res analytic evaluation, as in the reference.
        """
        if resolution not in ("low", "high", None):
            raise ValueError("resolution must be 'low', 'high' or None")
        if resolution is None:
            resolution = "low" if self.iscopol else "high"
        inc_step, wspd_step, phi_step = self._steps_for(resolution, **kwargs)
        inc = _grid(self.inc_range, inc_step)
        wspd = _grid(self.wspd_range, wspd_step)
        phi = _grid(self.phi_range, phi_step) if self.phi_range is not None else None
        lut = self.__call__(inc, wspd, phi)
        lut = lut.copy(data=lut.data.cpu().numpy())
        return lut.assign_attrs(resolution=resolution, units=self.units)
