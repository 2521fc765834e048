"""Sigma0 detrending for 'nice display' (xsarsea.ipynb example).

Port of ``examples/detrend_roughness.py`` (the reference
``docs/examples/xsarsea.ipynb``): divide out the incidence-angle trend
predicted by a GMF at (10 m/s, 45 deg), leaving the surface roughness
signal. Runs on the card by default, or with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from xsarsea_tpu_torch import sigma0_detrend
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.utils import resolve_device


def main(device="cuda", h=256, w=1024):
    dev = resolve_device(device)
    inc = np.linspace(19.0, 46.0, w)[None, :].repeat(h, 0)
    trend = np.asarray(get_model("gmf_cmod5n")(inc[0], np.array([10.0]),
                                               np.array([45.0]))).squeeze()
    rng = np.random.default_rng(0)
    roughness = 1.0 + 0.3 * np.sin(np.linspace(0, 40 * np.pi, w))[None, :]
    sigma0 = trend[None, :] * roughness * rng.gamma(60.0, 1 / 60.0, (h, w))

    detrended = sigma0_detrend(DimArray(sigma0, dims=("line", "sample")),
                               DimArray(inc, dims=("line", "sample")), device=dev)

    prof_raw = np.nanmean(sigma0, axis=0)
    prof_det = np.nanmean(np.asarray(detrended.values), axis=0)
    # the detrended profile should be flat across incidence (trend removed)
    slope_raw = np.polyfit(inc[0], prof_raw / prof_raw.mean(), 1)[0]
    slope_det = np.polyfit(inc[0], prof_det / prof_det.mean(), 1)[0]
    print(f"normalized incidence slope: raw {slope_raw:+.4f}/deg -> "
          f"detrended {slope_det:+.4f}/deg")
    if not abs(slope_det) < abs(slope_raw) / 5:
        raise RuntimeError("detrend_roughness: the detrended profile keeps its trend")
    return {"slope_raw": float(slope_raw), "slope_det": float(slope_det)}


if __name__ == "__main__":
    main()
