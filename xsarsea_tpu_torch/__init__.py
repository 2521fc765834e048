"""xsarsea_tpu_torch — SAR ocean wind retrieval in PyTorch, with CUDA kernels.

The port of ``xsarsea_tpu`` (JAX) to PyTorch and NVIDIA Hopper: GMF forward
models, LUTs and the dual-pol Bayesian wind inversion, whose fused path
runs two hand-written CUDA kernels (``xsarsea_tpu_torch.ops``). It imports
torch and numpy only; ``xsarsea_tpu`` stays the reference its tests hold
it against.
"""

__version__ = "0.1.0"

__all__ = ["DimArray", "from_dB", "to_dB", "windspeed"]

from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.utils import from_dB, to_dB
from xsarsea_tpu_torch import windspeed  # noqa: F401
