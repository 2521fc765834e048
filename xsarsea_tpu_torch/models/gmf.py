"""GmfModel: analytic GMFs as broadcasting torch functions.

Counterpart of ``xsarsea_tpu.models.gmf``. A registered GMF is a plain
function of tensors ``f(inc, wspd[, phi])`` that broadcasts, so one code
path serves scalar calls, N-D evaluation and 3-D LUT generation.

Precision follows the inputs: tensor inputs keep their floating dtype and
device; numpy arrays and Python numbers evaluate in float64 on the CPU.
Lazy evaluation over chunked inputs (``_LazyGmfEval``) is not ported yet.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.models.base import Model, _grid

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
        when an input is one).
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
        phi_t = _prep(phi, dtype, device) if self._needs_phi else None

        if broadcast:
            out = self._eval_broadcast(_prep(inc, dtype, device), _prep(wspd, dtype, device),
                                       phi_t)
            out = out.expand(torch.broadcast_shapes(*(tuple(np.shape(_raw(v))) for v in vals)))
            template = next((v for v in (inc, wspd, phi) if isinstance(v, DimArray)), None)
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
