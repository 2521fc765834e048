"""windspeed: wind retrieval from sigma0 and GMF/LUT models.

The ported part of ``xsarsea_tpu.windspeed``: models (analytic GMFs and the
LUT-file loaders), tables and the inversion. dsig/NESZ is not ported yet.
"""

__all__ = [
    "GmfModel",
    "InversionTables",
    "Model",
    "available_models",
    "get_model",
    "gmfs",
    "gmfs_impl",
    "invert_from_model",
    "invert_pixels",
    "prepare_tables",
    "register_cmod7",
    "register_luts",
    "register_nc_luts",
    "register_pickle_luts",
]

from xsarsea_tpu_torch.models import (
    GmfModel,
    Model,
    available_models,
    get_model,
    gmfs_impl,
    register_cmod7,
    register_luts,
    register_nc_luts,
    register_pickle_luts,
)
from xsarsea_tpu_torch.models import gmf as gmfs  # noqa: F401
from xsarsea_tpu_torch.windspeed.inversion import (
    InversionTables,
    invert_from_model,
    invert_pixels,
    prepare_tables,
)
