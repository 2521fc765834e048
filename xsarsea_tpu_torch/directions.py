"""Wind-direction convention conversions (counterpart of
``xsarsea_tpu.directions``).

Same conventions as the reference (``detrend.py:96-201``): meteorological
(degrees clockwise from north, direction *from*), oceanographic (*to*),
and image/antenna convention (radians anticlockwise from the sample axis).
The functions use only the argument's own arithmetic (``+ - * %``), so they
take floats, numpy arrays, tensors on any device and DimArrays over either,
and compute where the data lives. ``%`` is the floored modulo of Python,
numpy and ``torch.remainder``: the result has the divisor's sign, which the
wraps rely on for negative angles.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "dir_meteo_to_sample",
    "dir_sample_to_meteo",
    "dir_meteo_to_oceano",
    "dir_oceano_to_meteo",
    "dir_to_180",
    "dir_to_360",
]


def dir_meteo_to_sample(meteo_dir, ground_heading):
    """Meteorological N/S direction → image convention.

    Returns the angle in radians, relative to the sample axis,
    anticlockwise (reference detrend.py:96-111).
    """
    return np.pi / 2 - (meteo_dir - ground_heading) * (np.pi / 180.0)


def dir_sample_to_meteo(sample_dir, ground_heading):
    """Image direction (deg, anticlockwise from sample axis) → meteorological."""
    return 90.0 - sample_dir + ground_heading


def dir_meteo_to_oceano(meteo_dir):
    """Meteorological (from) → oceanographic (to) convention."""
    return (meteo_dir + 180.0) % 360.0


def dir_oceano_to_meteo(oceano_dir):
    """Oceanographic (to) → meteorological (from) convention."""
    return (oceano_dir - 180.0) % 360.0


def dir_to_180(angle):
    """Wrap angle in degrees to [-180, 180)."""
    return (angle + 180.0) % 360.0 - 180.0


def dir_to_360(angle):
    """Wrap angle in degrees to [0, 360)."""
    return (angle + 360.0) % 360.0
