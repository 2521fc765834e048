"""NcLutModel: tabulated models from xsarsea-schema netCDF LUT files
(counterpart of ``xsarsea_tpu.models.nc_lut``).

Global attributes are read at registration (cheap), the LUT payload only
when the model is evaluated or converted (reference models.py:350-450).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from xsarsea_tpu_torch.io.lut_io import read_lut, read_lut_attrs
from xsarsea_tpu_torch.models.base import LutModel

__all__ = ["NcLutModel", "register_nc_luts"]


class NcLutModel(LutModel):

    _name_prefix = "nc_lut_"
    _priority = 10

    @property
    def short_name(self):
        return self._short_name

    def __init__(self, path, **kwargs):
        name = os.path.splitext(os.path.basename(path))[0]
        attrs = read_lut_attrs(path)
        for attr in ("units", "pol", "resolution", "inc_range", "wspd_range",
                     "phi_range", "inc_step", "wspd_step", "phi_step"):
            if attr in attrs:
                v = attrs[attr]
                kwargs[attr] = list(np.atleast_1d(v)) if "range" in attr else v
        self._short_name = attrs.get("model", name)
        if kwargs.get("resolution") == "low":
            # a file with a low-res grid: its steps are the low-res steps
            for s in ("inc_step", "wspd_step", "phi_step"):
                if s in kwargs:
                    kwargs[s + "_lr"] = kwargs.pop(s)
        super().__init__(name, **kwargs)
        self.path = path

    def _raw_lut(self, **kwargs):
        lut = read_lut(self.path)
        return lut.assign_attrs(units=lut.attrs.get("units", self.units),
                                model=lut.attrs.get("model", self.name),
                                resolution=lut.attrs.get("resolution", self.resolution))


def register_nc_luts(topdir, gmf_names=None):
    """Register every ``nc_lut_*.nc`` under ``topdir`` (models.py:413-450)."""
    for path in sorted(glob.glob(os.path.join(topdir, f"{NcLutModel._name_prefix}*.nc"))):
        name = os.path.basename(path).replace(".nc", "")
        if gmf_names is None or name in gmf_names:
            NcLutModel(os.path.abspath(path))
