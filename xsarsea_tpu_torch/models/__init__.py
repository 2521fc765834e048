"""Model registry, analytic GMF implementations and LUT-file models."""

from xsarsea_tpu_torch.models.base import (  # noqa: F401
    LutModel,
    Model,
    available_models,
    get_model,
    register_luts,
)
from xsarsea_tpu_torch.models.gmf import GmfModel  # noqa: F401
from xsarsea_tpu_torch.models import gmfs_impl  # noqa: F401  (registers built-in GMFs)
from xsarsea_tpu_torch.models.nc_lut import NcLutModel, register_nc_luts  # noqa: F401
from xsarsea_tpu_torch.models.cmod7 import Cmod7Model, register_cmod7  # noqa: F401
from xsarsea_tpu_torch.models.pickle_lut import PickleLutModel, register_pickle_luts  # noqa: F401
