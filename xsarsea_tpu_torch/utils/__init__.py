"""Small shared helpers (counterpart of ``xsarsea_tpu.utils``).

Only the dB conversions the LUT and inversion paths need are ported so far.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_dB", "from_dB"]


def to_dB(x, eps=1e-15):
    """linear -> dB with the reference's epsilon clip (windspeed.py:126, models.py:215)."""
    if isinstance(x, torch.Tensor):
        return 10.0 * torch.log10(x + eps)
    return 10.0 * np.log10(np.asarray(x) + eps)


def from_dB(x):
    """dB -> linear (``**`` dispatches on the input's array type)."""
    return 10.0 ** (x / 10.0)
