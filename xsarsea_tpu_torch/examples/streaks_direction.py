"""Wind-streak direction from multi-scale gradients (streaks example).

Port of ``examples/streaks_direction.py`` (the reference
``docs/examples/streaks.ipynb``): build a sigma0 image with oriented streaks,
run the Koch-2004 multi-scale gradient histogram pipeline, smooth circularly,
and read the dominant direction off the histogram peak (180-degree
ambiguous). Runs on the card by default, or with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.gradients import Gradients, circ_smooth
from xsarsea_tpu_torch.utils import resolve_device


def streak_image(h, w, angle_deg, seed=0):
    """Random field with streak iso-lines at ``angle_deg`` from the sample
    (x) axis; the local gradients then point at angle_deg + 90."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (h, w))
    a = np.deg2rad(angle_deg)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    t = yy * np.cos(a) - xx * np.sin(a)  # coordinate across the streaks
    streaks = np.sin(2 * np.pi * t / 18.0)
    return 0.08 * np.exp(0.35 * streaks + 0.12 * base)


def main(device="cuda", h=512, w=512, truth=25.0):
    dev = resolve_device(device)
    img = streak_image(h, w, truth)
    da = DimArray(img[None], dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV"]), "line": np.arange(h), "sample": np.arange(w)})

    hist = Gradients(da, windows_sizes=[160], downscales_factors=[1, 2], device=dev).histogram
    weight = circ_smooth(hist["weight"].mean(dim=["downscale_factor", "window_size", "pol"]),
                         device=dev)
    angles = np.asarray(weight.coords["angles"])
    mean_w = weight.values.mean(axis=(0, 1))
    # gradients are perpendicular to the streaks: rotate 90 deg
    peak = float(np.rad2deg(angles[int(np.argmax(mean_w))]) + 90.0)
    err = (peak - truth + 90.0) % 180.0 - 90.0
    print(f"streak direction: truth {truth:.0f} deg, retrieved {peak:.1f} deg "
          f"(err {err:+.1f} deg, 180-deg ambiguous)")
    if not abs(err) < 7.5:
        raise RuntimeError(f"streaks_direction: error {err} deg, expected within 7.5")
    return {"peak": peak, "err": err}


if __name__ == "__main__":
    main()
