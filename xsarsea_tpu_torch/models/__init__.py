"""Model registry and analytic GMF implementations.

LUT-file models (netCDF, CMOD7, pickle) are not ported yet.
"""

from xsarsea_tpu_torch.models.base import Model, available_models, get_model  # noqa: F401
from xsarsea_tpu_torch.models.gmf import GmfModel  # noqa: F401
from xsarsea_tpu_torch.models import gmfs_impl  # noqa: F401  (registers built-in GMFs)
