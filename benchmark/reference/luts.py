"""The reference's own LUTs, rebuilt from the frozen GMFs and the raw files.

A configuration's ``tables`` entry says how each LUT is made, the way
xsarsea makes it:

* ``gmf``: the frozen GMF evaluated in float64 on its low-resolution grid
  (``low_steps``), re-gridded by separable linear interpolation to
  ``steps`` (incidence, then wind speed, then direction), converted to dB;
* ``cmod7``: KNMI's CMOD7 table (one Fortran record of 250 x 73 x 51
  float32 in Fortran order, here gzipped), re-gridded in float32 the same way;
* ``sarwing_pickle``: a sarwing LUT directory (``sigma.npy`` in dB, in the
  reversed dimension order, and the axes as pickles), on its own grid.

The values are then rounded to float32, the precision the configuration
states for its tables. Nothing here reads the program's tables.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.gmfs import GMFS


def grid(rng, step):
    """An inclusive linspace grid from a range and a step."""
    num = int(np.round((rng[1] - rng[0]) / step) + 1)
    return np.linspace(rng[0], rng[1], num=num)


def interp_axis(data, axis, old, new):
    """Linear interpolation of ``data`` along ``axis`` from ``old`` to
    ``new`` coordinates, in the data's dtype (weights cast to it)."""
    i1 = np.clip(np.searchsorted(old, new), 1, len(old) - 1)
    i0 = i1 - 1
    denom = old[i1] - old[i0]
    w = (new - old[i0]) / np.where(denom == 0, 1.0, denom)
    d = np.moveaxis(data, axis, 0)
    w = w.reshape((-1,) + (1,) * (d.ndim - 1)).astype(d.dtype)
    return np.moveaxis(d[i0] * (1 - w) + d[i1] * w, 0, axis)


def regrid(data, coords, targets):
    """Re-grid each axis whose coordinates differ from its target."""
    out = []
    for axis, (old, new) in enumerate(zip(coords, targets)):
        old = np.asarray(old, np.float64)
        if len(old) != len(new) or not np.allclose(old, new):
            data = interp_axis(data, axis, old, new)
            old = new
        out.append(old)
    return data, out


def to_db(x):
    return 10.0 * np.log10(x + 1e-15)


def _gmf_lut(spec):
    fn = GMFS[spec["gmf"]]
    ranges = [spec["inc_range"], spec["wspd_range"]] + (
        [spec["phi_range"]] if "phi_range" in spec else [])
    low = [torch.as_tensor(grid(r, s)) for r, s in zip(ranges, spec["low_steps"])]
    if len(low) == 3:
        vals = fn(low[0][:, None, None], low[1][None, :, None], low[2][None, None, :])
    else:
        vals = fn(low[0][:, None], low[1][None, :])
    targets = [grid(r, s) for r, s in zip(ranges, spec["steps"])]
    data, coords = regrid(vals.numpy(), [a.numpy() for a in low], targets)
    return to_db(data), coords


def read_cmod7(path):
    """KNMI's table as (incidence, wspd, phi) linear float32."""
    with gzip.open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype="<f4")
    raw = raw[1:-1]  # the Fortran record's two length markers
    return np.ascontiguousarray(raw.reshape((250, 73, 51), order="F").transpose(2, 0, 1))


def _cmod7_lut(spec, root):
    data = read_cmod7(Path(root) / spec["file"])
    coords = [np.arange(16.0, 66.0 + 1.0, 1.0), np.arange(0.2, 50.0 + 0.2, 0.2),
              np.arange(0.0, 180.0 + 2.5, 2.5)]
    ranges = [spec["inc_range"], spec["wspd_range"], spec["phi_range"]]
    targets = [grid(r, s) for r, s in zip(ranges, spec["steps"])]
    data, coords = regrid(data, coords, targets)
    return to_db(data), coords


def _sarwing_lut(spec, root):
    d = Path(root) / spec["dir"]
    sigma_db = np.ascontiguousarray(np.load(d / "sigma.npy"))  # (incidence, wspd)
    with open(d / "incidence_angle.pkl", "rb") as f:
        inc = pickle.load(f, encoding="iso-8859-1")
    with open(d / "wind_speed.pkl", "rb") as f:
        wspd = pickle.load(f, encoding="iso-8859-1")
    return sigma_db, [np.asarray(inc, np.float64), np.asarray(wspd, np.float64)]


_KINDS = {"gmf": lambda spec, root: _gmf_lut(spec), "cmod7": _cmod7_lut,
          "sarwing_pickle": _sarwing_lut}


class Tables:
    """The reference's LUTs in float32 as the configuration states them:
    copol ``co_lut`` (incidence, wspd, phi) dB with its axes and wind
    components, crosspol ``cr_lut`` (incidence, wspd) dB with its axes."""

    def __init__(self, config, root):
        co_db, (inc, wspd, phi) = _KINDS[config["tables"]["copol"]["kind"]](
            config["tables"]["copol"], root)
        cr_db, (cr_inc, cr_wspd) = _KINDS[config["tables"]["crosspol"]["kind"]](
            config["tables"]["crosspol"], root)
        f32 = np.float32
        self.co_lut = np.ascontiguousarray(co_db, f32)
        self.co_inc = inc.astype(f32)
        self.co_wspd = wspd.astype(f32)
        self.co_phi = phi.astype(f32)
        phir = np.deg2rad(phi)
        self.co_u = (wspd[:, None] * np.cos(phir)[None, :]).astype(f32)
        self.co_v = (wspd[:, None] * np.sin(phir)[None, :]).astype(f32)
        self.phi_180 = bool((180.0 - (phi[-1] - phi[0])) < 2.0)
        self.cr_lut = np.ascontiguousarray(cr_db, f32)
        self.cr_inc = cr_inc.astype(f32)
        self.cr_wspd = cr_wspd.astype(f32)
