"""GMF registry tour and a custom model's registration (gmfs_and_luts example).

Port of ``examples/gmfs_and_luts.py`` (the reference
``docs/examples/gmfs_and_luts.ipynb`` and ``create_hh_lut.ipynb``): list the
models, evaluate an analytic GMF on ``device`` (default the card), generate
LUTs, register a user GMF (any torch-traceable function of tensors, here one
of plain arithmetic), build an HH LUT from a VV GMF with a polarization
ratio, and round-trip a LUT through netCDF.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from xsarsea_tpu_torch.models import available_models, get_model
from xsarsea_tpu_torch.models.gmf import GmfModel
from xsarsea_tpu_torch.models.nc_lut import register_nc_luts
from xsarsea_tpu_torch.utils import resolve_device


def gmf_demo(inc, wspd, phi=None):
    """A user GMF: arithmetic on tensors (or floats), so torch traces it."""
    a = 1e-3 * (1.0 + 0.02 * (35.0 - inc))
    return a * wspd ** 1.4


def main(device="cuda"):
    dev = resolve_device(device)
    for name, row in available_models().items():
        print(f"{name:40s} {row['alias']!s:20s} {row['pol']}")

    m = get_model("cmod5n")

    def on_device(*values):
        return [torch.tensor([v], dtype=torch.float64, device=dev) for v in values]

    s0 = float(m(*on_device(35.0, 15.0, 90.0)).values.reshape(-1)[0])
    print(f"\ncmod5n(35, 15, 90) = {s0} (on {dev})")

    lut = m.to_lut(units="dB")  # high-res LUT
    print("high-res LUT:", lut.dims, lut.shape)

    GmfModel.register_function(gmf_demo, "gmf_demo_vh", pol="VH", units="linear")
    demo = get_model("gmf_demo_vh")
    s0_demo = float(demo(*on_device(30.0, 10.0)).values.reshape(-1)[0])
    print("\nregistered:", demo.name, demo.pol, "-> sigma0(30,10) =", s0_demo)

    # HH LUT from a VV GMF via the Zhang-A polarization ratio
    lut_hh = get_model("gmf_cmod5n_pr_zhangA").to_lut(units="dB", resolution="low")
    print("\nHH LUT (cmod5n x ZhangA PR):", lut_hh.dims, lut_hh.shape)

    # netCDF round-trip: export, register, reload
    with tempfile.TemporaryDirectory() as d:
        demo.to_netcdf(os.path.join(d, "nc_lut_gmf_demo_vh.nc"))
        register_nc_luts(d)
        reloaded = get_model("nc_lut_gmf_demo_vh")
        # crosspol models are stored at high resolution (copol at low, as the
        # reference): the low-res grid's nodes are a subset of the stored
        # grid, so the reload's interpolation selects nodes and only the
        # dB <-> linear conversion rounds
        a = np.asarray(reloaded.to_lut(units="linear", resolution="low").values)
        b = np.asarray(demo.to_lut(units="linear", resolution="low").values)
        rel_low = float(np.nanmax(np.abs(a - b) / np.abs(b)))
        print("netCDF round-trip (shared grid nodes) max |rel err|:", rel_low)
        # at full resolution the reloaded side is the stored direct high-res
        # evaluation, while an analytic model's default to_lut() interpolates
        # its native low grid up (models.py:108-167): this is the default
        # path's resolution interpolation error, not a serialization error
        ah = np.asarray(reloaded.to_lut(units="linear").values)
        bh = np.asarray(demo.to_lut(units="linear").values)
        rel_high = float(np.nanmax(np.abs(ah - bh) / np.abs(bh)))
        print("default (interp) vs stored direct high-res eval max |rel err|:", rel_high)
    return {"cmod5n": s0, "demo": s0_demo, "rel_low": rel_low, "rel_high": rel_high}


if __name__ == "__main__":
    main()
