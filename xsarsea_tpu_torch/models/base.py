"""Model registry: abstract Model, LUT normalization, alias resolution.

Counterpart of ``xsarsea_tpu.models.base``. LUTs are
:class:`~xsarsea_tpu_torch.dimarray.DimArray` objects with host numpy
payloads; re-gridding is separable linear interpolation. Alias resolution
is a plain priority rule over the registry (no table library).
``to_netcdf`` and ``register_luts`` are not ported yet.
"""

from __future__ import annotations

import logging

import numpy as np

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.utils import from_dB, to_dB

logger = logging.getLogger("xsarsea_tpu_torch.models")

__all__ = ["Model", "available_models", "get_model"]


def _grid(rng, step):
    """linspace grid from an inclusive range and step (models.py:154-160)."""
    if rng is None:
        return None
    num = int(np.round((rng[1] - rng[0]) / step) + 1)
    return np.linspace(rng[0], rng[1], num=num)


def _hashable(v):
    return tuple(v) if isinstance(v, (list, np.ndarray)) else v


class Model:
    """Abstract GMF/LUT model. Instances self-register by name.

    Short names are aliased to the lowest-priority implementation, mirroring
    the reference resolution table (models.py:453-507).
    """

    _available_models: dict = {}
    _name_prefix = ""
    _priority = None

    # default LUT generation parameters (reference models.py:38-48)
    DEFAULT_INC_RANGE = [16.0, 66.0]

    def __init__(self, name, **kwargs):
        self.name = name
        self.pol = kwargs.pop("pol", None)
        self.units = kwargs.pop("units", None)
        self.phi_range = kwargs.pop("phi_range", None)
        self.wspd_range = kwargs.pop("wspd_range", None)
        self.inc_range = kwargs.pop("inc_range", None) or list(self.DEFAULT_INC_RANGE)
        self.resolution = kwargs.pop("resolution", None)

        self.inc_step_lr = kwargs.pop("inc_step_lr", 1.0)
        self.wspd_step_lr = kwargs.pop("wspd_step_lr", 0.2)
        self.phi_step_lr = kwargs.pop("phi_step_lr", 2.5)
        self.inc_step = kwargs.pop("inc_step", 0.1)
        self.wspd_step = kwargs.pop("wspd_step", 0.1)
        self.phi_step = kwargs.pop("phi_step", 1.0)

        for k, v in kwargs.items():
            setattr(self, k, v)

        self._lut_cache = {}
        Model._available_models[name] = self
        logger.debug("registered model %s pol=%s units=%s", name, self.pol, self.units)

    @property
    def short_name(self):
        if self._name_prefix and self.name.startswith(self._name_prefix):
            return self.name[len(self._name_prefix):]
        return None

    @property
    def iscopol(self):
        """True if model is copol (e.g. 'VV', 'HH')."""
        return self.pol is not None and len(set(self.pol)) == 1

    @property
    def iscrosspol(self):
        """True if model is crosspol (e.g. 'VH', 'HV')."""
        return self.pol is not None and len(set(self.pol)) == 2

    def __repr__(self):
        return f"<{self.__class__.__name__}('{self.name}') pol={self.pol}>"

    def _raw_lut(self, **kwargs):
        raise NotImplementedError

    def _steps_for(self, resolution, **overrides):
        if resolution == "low":
            return (overrides.get("inc_step_lr", self.inc_step_lr),
                    overrides.get("wspd_step_lr", self.wspd_step_lr),
                    overrides.get("phi_step_lr", self.phi_step_lr))
        return (overrides.get("inc_step", self.inc_step),
                overrides.get("wspd_step", self.wspd_step),
                overrides.get("phi_step", self.phi_step))

    def _normalize_lut(self, lut: DimArray, resolution="high", **kwargs):
        """Validate dims and re-grid the raw LUT to the requested resolution
        (reference models.py:82-174): the target grid is rebuilt from
        (range, step) per dim; skipped when the raw grid already matches."""
        if lut.dims not in (("incidence", "wspd"), ("incidence", "wspd", "phi")):
            raise IndexError(f"Bad lut dims {lut.dims}")
        units = lut.attrs.get("units")
        if units not in ("linear", "dB"):
            raise ValueError(f"Unknown lut units '{units}'")
        if resolution is None:
            resolution = "high"
        inc_step, wspd_step, phi_step = self._steps_for(resolution, **kwargs)

        target = {"incidence": _grid(self.inc_range, inc_step),
                  "wspd": _grid(self.wspd_range, wspd_step)}
        if "phi" in lut.dims and self.phi_range is not None:
            target["phi"] = _grid(self.phi_range, phi_step)

        needs = {}
        for dim, tgt in target.items():
            if tgt is None:
                continue
            cur = np.asarray(lut.coords[dim], dtype=np.float64)
            if len(cur) != len(tgt) or not np.allclose(cur, tgt):
                needs[dim] = tgt
        if needs:
            lut = lut.interp(needs, bounds_error=True)
        return lut.assign_attrs(resolution=resolution)

    def to_lut(self, units="linear", **kwargs):
        """Return the model LUT as a DimArray (dims incidence, wspd[, phi]).

        ``units`` in {'linear', 'dB', None}, ``resolution`` in
        {'high', 'low', None} plus per-dim step overrides (reference
        models.py:186-230). Results are cached per arguments; the cached
        numpy buffer is frozen and every hit returns a fresh container.
        """
        key = (units, tuple(sorted((k, _hashable(v)) for k, v in kwargs.items())))
        if key in self._lut_cache:
            return self._lut_cache[key].copy()

        # the resolution kwarg reaches _raw_lut only when explicitly given:
        # an analytic model generates at its native (low) grid and is then
        # interpolated to the high-res target (gmfs.py:353, models.py:108-167)
        unset = object()
        user_res = kwargs.pop("resolution", unset)
        raw_kwargs = dict(kwargs)
        if user_res is not unset:
            raw_kwargs["resolution"] = user_res
        lut = self._raw_lut(**raw_kwargs)
        resolution = "high" if user_res in (unset, None) else user_res
        lut = self._normalize_lut(lut, resolution=resolution, **kwargs)

        if units is not None and units != lut.attrs["units"]:
            if units == "dB":
                lut = lut.copy(data=to_dB(lut.data)).assign_attrs(units="dB")
            elif units == "linear":
                lut = lut.copy(data=from_dB(lut.data)).assign_attrs(units="linear")
            else:
                raise ValueError(f"Unit not known: {units}")

        lut = lut.assign_attrs(model=self.name, pol=self.pol)
        lut.name = "sigma0_model"
        if isinstance(lut.data, np.ndarray):
            lut.data.flags.writeable = False
        self._lut_cache[key] = lut
        return lut.copy()

    def __call__(self, inc, wspd, phi=None, broadcast=False):
        raise NotImplementedError(self.__class__)


def available_models(pol=None):
    """Registered models with alias resolution.

    Returns ``{name: {"alias", "pol", "model"}}`` in registration order.
    Among models sharing a short name the lowest ``_priority`` owns the
    alias (ties: first registered), as the reference rule
    (models.py:453-498); a model with no short name gets no alias.
    """
    owner = {}
    for name, model in Model._available_models.items():
        short = model.short_name
        if short is None:
            continue
        prio = model._priority if model._priority is not None else np.inf
        if short not in owner or prio < owner[short][0]:
            owner[short] = (prio, name)
    alias_of = {name: short for short, (_, name) in owner.items()}
    return {name: {"alias": alias_of.get(name), "pol": model.pol, "model": model}
            for name, model in Model._available_models.items()
            if pol is None or model.pol == pol}


def get_model(name):
    """Resolve a model by exact name or by alias (models.py:510-538)."""
    if isinstance(name, Model):
        return name
    models = Model._available_models
    if name in models:
        return models[name]
    match = [row["model"] for row in available_models().values() if row["alias"] == name]
    if len(match) == 1:
        return match[0]
    raise KeyError(f"model {name} not found")
