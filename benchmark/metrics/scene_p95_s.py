"""The 95th percentile of the per-scene time, from the call to the winds in
the caller's hands (synchronized), over every scene of the window."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.scene_s, dtype=np.float64), 95))
