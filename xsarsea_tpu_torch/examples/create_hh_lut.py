"""Create HH LUTs from a VV model and a polarization ratio.

Port of ``examples/create_hh_lut.py`` (the reference
``docs/examples/create_hh_lut.ipynb``): HH backscatter GMFs are a VV model
divided by a polarization ratio PR(incidence, wspd) (Zhang) or
PR(incidence, phi) (Mouche). The port ships both as registered analytic HH
models (``gmf_cmod5n_pr_zhangA`` / ``gmf_cmod5n_pr_mouche1``); this example
also runs the notebook's LUT-file workflow (derive an HH LUT from a VV LUT,
export it to netCDF, register it back as a LUT model) and inverts HH sigma0
with the result on ``device`` (default the card), in the exact mode as its
counterpart.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.io.lut_io import write_lut
from xsarsea_tpu_torch.models import get_model, register_nc_luts
from xsarsea_tpu_torch.models.gmfs_impl import _pr_mouche1
from xsarsea_tpu_torch.utils import resolve_device
from xsarsea_tpu_torch.windspeed import invert_from_model


def main(device="cuda", ny=48, nx=64):
    dev = resolve_device(device)
    # 1. the built-in analytic HH models (PR applied inside the GMF)
    for name in ("gmf_cmod5n_pr_zhangA", "gmf_cmod5n_pr_mouche1"):
        m = get_model(name)
        print(f"{name} (pol={m.pol}): sigma0(35deg, 10m/s, 45deg) = {m(35.0, 10.0, 45.0):.5f} lin")

    # 2. the notebook's file workflow: VV LUT / PR -> HH LUT -> netCDF ->
    #    registered LUT model (reference create_gmfHH)
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    lut_vv = get_model("gmf_cmod5n").to_lut(units="linear", **kwargs)
    inc = np.asarray(lut_vv.coords["incidence"])
    phi = np.asarray(lut_vv.coords["phi"])
    # Mouche PR depends on (incidence, phi): broadcast over the LUT grid
    pr = _pr_mouche1(torch.as_tensor(inc[:, None]), torch.as_tensor(phi[None, :])).numpy()
    hh_db = 10.0 * np.log10(np.asarray(lut_vv.values) / pr[:, None, :] + 1e-15)
    lut_hh = DimArray(hh_db, dims=lut_vv.dims, coords=lut_vv.coords, name="sigma0_gmf")

    with tempfile.TemporaryDirectory(prefix="hh_lut_") as d:
        path = os.path.join(d, "nc_lut_cmod5n_hh_mouche1.nc")
        write_lut(path, lut_hh, {
            "units": "dB", "pol": "HH", "model": "cmod5n_hh_mouche1", "resolution": "high",
            "inc_range": np.array([inc[0], inc[-1]]),
            "wspd_range": np.asarray(lut_vv.coords["wspd"])[[0, -1]],
            "phi_range": np.array([phi[0], phi[-1]]),
            "inc_step": 0.5, "wspd_step": 0.5, "phi_step": 5.0,
        })
        register_nc_luts(d)
        m_hh = get_model("nc_lut_cmod5n_hh_mouche1")
        print(f"registered {m_hh.name} (pol={m_hh.pol}) from {path}")

        # 3. invert HH sigma0 with the derived LUT
        rng = np.random.default_rng(0)
        inc2 = np.linspace(20.0, 44.0, nx)[None, :].repeat(ny, 0)
        wspd = rng.uniform(3.0, 22.0, (ny, nx))
        direc = rng.uniform(-180.0, 180.0, (ny, nx))
        s0_hh = np.asarray(get_model("gmf_cmod5n_pr_mouche1")(inc2, wspd, np.abs(direc)))
        anc = wspd * np.exp(1j * np.deg2rad(direc))
        wind = invert_from_model(inc2, s0_hh, ancillary_wind=anc, model=m_hh, mode="exact",
                                 device=dev, **kwargs)
    rms = float(np.sqrt(np.nanmean((np.abs(wind) - wspd) ** 2)))
    print(f"HH inversion through the derived LUT: RMS vs truth {rms:.2f} m/s")
    if not rms < 1.0:
        raise RuntimeError(f"create_hh_lut: RMS {rms} m/s, expected < 1.0")
    return {"rms": rms}


if __name__ == "__main__":
    main()
