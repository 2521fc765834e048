"""CMOD7 tabulated GMF from the KNMI binary distribution (counterpart of
``xsarsea_tpu.models.cmod7``).

Reads the little-endian float32 table ``gmf_cmod7_vv.dat_little_endian``:
one Fortran unformatted record (an int32 length marker before and after)
holding 250 wspd x 73 phi x 51 incidence values in Fortran order (reference
``cmod7.py:19-75``), decoded by the native codec ``xsarsea_tpu_torch._lutio``
when it is built and by numpy otherwise (the same array). Source:
https://scatterometer.knmi.nl/cmod7
"""

from __future__ import annotations

import os

import numpy as np

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.io.lut_io import native_codec
from xsarsea_tpu_torch.models.base import LutModel

__all__ = ["Cmod7Model", "register_cmod7"]

TABLE_FILE = "gmf_cmod7_vv.dat_little_endian"


def decode_python(table_path):
    """The table as (incidence, wspd, phi) float32, decoded by numpy (the
    native codec's ``decode_cmod7`` gives the same array)."""
    m, n, p = 250, 73, 51  # wspd, phi, incidence
    raw = np.fromfile(table_path, dtype="<f4")
    raw = raw[1:-1]  # strip the Fortran record's length markers
    return np.ascontiguousarray(raw.reshape((m, n, p), order="F").transpose(2, 0, 1))


class Cmod7Model(LutModel):

    _name_prefix = "gmf_"
    _priority = 1

    def __init__(self, name, path, **kwargs):
        kwargs.setdefault("units", "linear")
        kwargs.setdefault("resolution", "low")
        kwargs.setdefault("inc_range", [16.0, 66.0])
        kwargs.setdefault("wspd_range", [0.2, 50.0])
        kwargs.setdefault("phi_range", [0.0, 180.0])
        kwargs.setdefault("inc_step_lr", 1.0)
        kwargs.setdefault("wspd_step_lr", 0.2)
        kwargs.setdefault("phi_step_lr", 2.5)
        super().__init__(name, **kwargs)
        self.path = path

    def _raw_lut(self, **kwargs):
        if not os.path.isdir(self.path):
            raise FileNotFoundError(self.path)
        table_path = os.path.join(self.path, TABLE_FILE)
        _lutio = native_codec()
        if _lutio is not None:  # the record stripped and permuted in one pass
            sigma0 = _lutio.decode_cmod7(table_path)  # (incidence, wspd, phi)
        else:
            sigma0 = decode_python(table_path)
        return DimArray(
            sigma0,
            dims=("incidence", "wspd", "phi"),
            coords={"wspd": np.arange(0.2, 50.0 + 0.2, 0.2),
                    "phi": np.arange(0.0, 180.0 + 2.5, 2.5),
                    "incidence": np.arange(16.0, 66.0 + 1.0, 1.0)},
            attrs={"units": "linear", "model": self.name, "resolution": "low"},
            name="sigma0_gmf",
        )


def register_cmod7(topdir):
    """Register the CMOD7 LUT found under ``topdir`` (cmod7.py:78-106)."""
    Cmod7Model(Cmod7Model._name_prefix + "cmod7", topdir, pol="VV")
