"""Out-of-core processing: invert and analyse a scene straight from disk.

Port of ``examples/out_of_core_scene.py``. The reference runs dask-chunked
DataArrays chunk by chunk (windspeed.py:345-367, gradients.py:649-667); the
port streams any chunked or lazy array (dask, zarr, h5py, ``np.memmap``):
``invert_from_model`` prepares pieces on the host and overlaps their copies
with the kernels, and ``Gradients2D.histogram`` streams row bands with their
stencil halos. Host memory stays O(piece/band) beside the outputs whatever
the scene's size (``scripts/demo_full_scene.py`` runs this at 10^8 px).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.gradients import Gradients2D
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.utils import resolve_device
from xsarsea_tpu_torch.windspeed import invert_from_model


class Chunked:
    """A ``.chunks`` attribute marks an array as lazy (``np.memmap`` itself
    is an ndarray): this wraps one the way dask and zarr stores present
    themselves, with 64-row chunks and first-axis slicing."""

    def __init__(self, a):
        self.a, self.shape, self.ndim, self.dtype = a, a.shape, a.ndim, a.dtype
        self.chunks = ((64,) * (a.shape[0] // 64), (a.shape[1],))

    def __getitem__(self, idx):
        return self.a[idx]


def main(device="cuda", ny=384, nx=320):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    inc = np.linspace(19.0, 46.0, nx)[None, :].repeat(ny, 0)
    wspd = rng.uniform(2.0, 25.0, (ny, nx))
    phi = rng.uniform(-180.0, 180.0, (ny, nx))
    inc_t, wspd_t, phi_t = (torch.as_tensor(a, device=dev) for a in (inc, wspd, np.abs(phi)))
    s0_co = get_model("gmf_cmod5n")(inc_t, wspd_t, phi_t, broadcast=True).cpu().numpy()
    s0_cr = get_model("gmf_s1_v2")(inc_t, wspd_t, broadcast=True).cpu().numpy()
    anc = wspd * np.exp(1j * np.deg2rad(phi))

    with tempfile.TemporaryDirectory(prefix="ooc_scene_") as d:
        # the scene on disk, memory-mapped back (a zarr store or a dask-backed
        # DataArray streams the same way)
        for name, arr in (("inc", inc), ("s0_co", s0_co), ("s0_cr", s0_cr), ("anc", anc)):
            np.save(os.path.join(d, f"{name}.npy"), arr)
        mm = {k: np.load(os.path.join(d, f"{k}.npy"), mmap_mode="r")
              for k in ("inc", "s0_co", "s0_cr", "anc")}

        # dual-pol inversion, streamed in pieces (a small piece size to show
        # the streaming; the default is 4M px)
        _, wind_dual = invert_from_model(
            mm["inc"], mm["s0_co"], mm["s0_cr"], ancillary_wind=mm["anc"], dsig_cr=0.1,
            model=("gmf_cmod5n", "gmf_s1_v2"), piece_size=1 << 15, device=dev)
        rms = float(np.sqrt(np.nanmean((np.abs(wind_dual) - wspd) ** 2)))
        print(f"streamed dual-pol inversion of {ny}x{nx} px from disk: "
              f"RMS vs truth {rms:.3f} m/s")

        # wind-streak histograms, streamed in row bands with stencil halos
        hist = Gradients2D(DimArray(Chunked(mm["s0_co"]), dims=("line", "sample"),
                                    coords={"line": np.arange(ny) * 10.0,
                                            "sample": np.arange(nx) * 10.0}),
                           window_size=800, device=dev).histogram
        w = hist["weight"].values
    print(f"banded streaks histogram: {w.shape[0]}x{w.shape[1]} windows, "
          f"{w.shape[2]} angle bins, total weight {w.sum():.3f}")
    if not np.isfinite(w).all():
        raise RuntimeError("out_of_core_scene: non-finite histogram weights")
    return {"rms": rms, "windows": w.shape[:2], "total_weight": float(w.sum())}


if __name__ == "__main__":
    main()
