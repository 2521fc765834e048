"""windspeed: wind retrieval from sigma0 and GMF models.

The ported part of ``xsarsea_tpu.windspeed``: models, tables and the
inversion. dsig/NESZ and the LUT-file loaders are not ported yet.
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
]

from xsarsea_tpu_torch.models import GmfModel, Model, available_models, get_model, gmfs_impl
from xsarsea_tpu_torch.models import gmf as gmfs  # noqa: F401
from xsarsea_tpu_torch.windspeed.inversion import (
    InversionTables,
    invert_from_model,
    invert_pixels,
    prepare_tables,
)
