"""xsarsea_tpu_torch — SAR ocean wind retrieval in PyTorch, with CUDA kernels.

The port of ``xsarsea_tpu`` (JAX) to PyTorch and NVIDIA Hopper: GMF forward
models, LUTs, the dual-pol Bayesian wind inversion, whose fused path runs
hand-written CUDA kernels (``xsarsea_tpu_torch.ops``), and the scene
preparation around it: wind-direction conventions, NESZ flattening, dsig
weightings, sigma0 detrending, the sarwing OWI reader and the xarray bridge;
and the wind-streak direction analysis (``xsarsea_tpu_torch.gradients``).
It imports torch and numpy only; ``xsarsea_tpu`` stays the reference its
tests hold it against.
"""

__version__ = "0.1.0"

__all__ = [
    "sigma0_detrend",
    "dir_meteo_to_sample",
    "dir_sample_to_meteo",
    "dir_meteo_to_oceano",
    "dir_oceano_to_meteo",
    "dir_to_180",
    "dir_to_360",
    "read_sarwing_owi",
    "DimArray",
    "DimDataset",
    "from_dB",
    "to_dB",
    "to_dimarray",
    "to_dataarray",
    "utils",
    "windspeed",
    "gradients",
]

from xsarsea_tpu_torch.dimarray import DimArray, DimDataset
from xsarsea_tpu_torch.interop import to_dataarray, to_dimarray
from xsarsea_tpu_torch.detrend import read_sarwing_owi, sigma0_detrend
from xsarsea_tpu_torch.directions import (
    dir_meteo_to_oceano,
    dir_meteo_to_sample,
    dir_oceano_to_meteo,
    dir_sample_to_meteo,
    dir_to_180,
    dir_to_360,
)
from xsarsea_tpu_torch import utils  # noqa: F401
from xsarsea_tpu_torch.utils import from_dB, to_dB
from xsarsea_tpu_torch import windspeed  # noqa: F401
from xsarsea_tpu_torch import gradients  # noqa: F401
