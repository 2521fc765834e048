"""The wind-streak histograms with the image split into line bands over a
mesh (counterpart of ``xsarsea_tpu.parallel.gradients``).

The window-center rows split into contiguous groups, one a device of the
data axis; each group runs through the port's out-of-core banded path
(``gradients._banded_streaks_hist``), which reads only the image rows its
windows and the stencils' halo need and computes them with the one-device
core. The reference's counterpart is dask ``map_overlap`` (gradients.py:
649-667); the JAX package lets XLA SPMD insert the halo exchanges.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from xsarsea_tpu_torch.gradients import _banded_streaks_hist
from xsarsea_tpu_torch.parallel.mesh import run_on_devices

__all__ = ["sharded_streaks_histogram"]


def sharded_streaks_histogram(img, centers_l, centers_s, window, angles_bins, mesh,
                              data_axis="data"):
    """Streaks histograms with the image's lines split over ``mesh``'s
    ``data_axis``.

    ``img``: (line, sample) linear sigma0 (numpy, a tensor, or a duck array
    with first-axis slicing); ``centers_l``/``centers_s``: window-center
    indices in local-gradient pixels; ``window``: window size in lg pixels;
    ``angles_bins``: bin centers. Returns host numpy (weight (n_l, n_s,
    n_angles), used_ratio (n_l, n_s)), the one-device
    :func:`~xsarsea_tpu_torch.gradients.streaks_histogram_core` result.
    """
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    cl = np.asarray(centers_l, dtype=np.int64)
    cs = np.asarray(centers_s, dtype=np.int64)
    if data_axis == "data":
        devices = [row[0] for row in mesh.devices]
    else:
        devices = list(mesh.devices[0])
    groups = [g for g in np.array_split(np.arange(cl.shape[0]), len(devices)) if g.size]

    def band(k):
        hist, ratio = _banded_streaks_hist(img, cl[groups[k]], cs, int(window), angles_bins,
                                           device=devices[k])
        return hist.cpu().numpy(), ratio.cpu().numpy()

    parts = run_on_devices([(devices[k], partial(band, k)) for k in range(len(groups))])
    n_l, n_s = cl.shape[0], cs.shape[0]
    weight = np.concatenate([h for h, _ in parts]).reshape(n_l, n_s, -1)
    ratio = np.concatenate([r for _, r in parts]).reshape(n_l, n_s)
    return weight, ratio
