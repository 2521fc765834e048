"""Legacy sarwing pickle-LUT reader (counterpart of
``xsarsea_tpu.models.pickle_lut``).

Loads the historical sarwing LUT directory layout (``sigma.npy`` in reversed
dim order, ``incidence_angle.pkl``, ``wind_speed[_and_direction].pkl``),
inferring the polarization from the files present (reference
``pickle_luts.py:20-133``). The LUT fixes its own grid: its ranges and steps
become the model's, so the high-resolution LUT is the file's grid.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.models.base import LutModel

__all__ = ["PickleLutModel", "register_pickle_luts"]


class PickleLutModel(LutModel):

    _name_prefix = "sarwing_lut__"
    _priority = 10

    def __init__(self, name, path, **kwargs):
        super().__init__(name, **kwargs)
        self.path = path

    def _raw_lut(self, **kwargs):
        if not os.path.isdir(self.path):
            raise FileNotFoundError(self.path)

        sigma0_db = np.ascontiguousarray(np.load(os.path.join(self.path, "sigma.npy")).T)
        # py2-era pickles written by the sarwing tools; only files the user
        # registered are read
        with open(os.path.join(self.path, "incidence_angle.pkl"), "rb") as f:
            inc = pickle.load(f, encoding="iso-8859-1")
        try:
            with open(os.path.join(self.path, "wind_speed_and_direction.pkl"), "rb") as f:
                phi, wspd = pickle.load(f, encoding="iso-8859-1")
        except FileNotFoundError:
            phi = None
            with open(os.path.join(self.path, "wind_speed.pkl"), "rb") as f:
                wspd = pickle.load(f, encoding="iso-8859-1")

        self.wspd_step = float(np.round(np.diff(wspd).mean(), 2))
        self.inc_step = float(np.round(np.diff(inc).mean(), 2))
        self.inc_range = [float(np.round(np.min(inc), 2)), float(np.round(np.max(inc), 2))]
        self.wspd_range = [float(np.round(np.min(wspd), 2)), float(np.round(np.max(wspd), 2))]

        if phi is not None:
            dims = ("wspd", "phi", "incidence")
            coords = {"incidence": inc, "phi": phi, "wspd": wspd}
            self.phi_step = float(np.round(np.diff(phi).mean(), 2))
            self.phi_range = [float(np.round(np.min(phi), 2)), float(np.round(np.max(phi), 2))]
            self.inc_step_lr, self.wspd_step_lr, self.phi_step_lr = 1.0, 0.4, 2.5
            final = ("incidence", "wspd", "phi")
        else:
            dims = ("wspd", "incidence")
            coords = {"incidence": inc, "wspd": wspd}
            self.inc_step_lr, self.wspd_step_lr, self.phi_step_lr = 1.0, 0.1, 1.0
            final = ("incidence", "wspd")

        lut = DimArray(sigma0_db, dims=dims, coords=coords,
                       attrs={"units": "dB", "model": self.name, "resolution": "high"},
                       name="sigma0_gmf")
        return lut.transpose(*final)


def register_pickle_luts(path):
    """Register the sarwing pickle LUT at ``path`` (a ``GMF_*`` dir) or every
    ``GMF_*`` subdir of it."""

    def register_one(p):
        name = os.path.basename(p).replace("GMF_", PickleLutModel._name_prefix)
        if os.path.exists(os.path.join(p, "wind_speed_and_direction.pkl")):
            pol = "VV"
        elif os.path.exists(os.path.join(p, "wind_speed.pkl")):
            pol = "VH"
        else:
            pol = None
        PickleLutModel(name, p, pol=pol)

    if os.path.basename(os.path.normpath(path)).startswith("GMF_"):
        register_one(path)
    elif os.path.isdir(path):
        for fn in sorted(os.listdir(path)):
            sub = os.path.join(path, fn)
            if os.path.isdir(sub) and fn.startswith("GMF_"):
                register_one(sub)
