"""windspeed: wind retrieval from sigma0 and GMF/LUT models.

Counterpart of ``xsarsea_tpu.windspeed``: models (analytic GMFs and the
LUT-file loaders), tables, the inversion, the dsig weightings and NESZ
flattening.
"""

__all__ = [
    "GmfModel",
    "InversionTables",
    "Model",
    "available_models",
    "get_model",
    "get_dsig",
    "get_dsig_wspd",
    "gmfs",
    "gmfs_impl",
    "invert_from_model",
    "invert_pixels",
    "nesz_flattening",
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
from xsarsea_tpu_torch.windspeed.dsig import get_dsig, get_dsig_wspd, nesz_flattening
from xsarsea_tpu_torch.windspeed.inversion import (
    InversionTables,
    invert_from_model,
    invert_pixels,
    prepare_tables,
)
