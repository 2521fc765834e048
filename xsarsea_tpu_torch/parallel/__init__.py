"""Several devices, and batches of scenes (counterpart of
``xsarsea_tpu.parallel``): a (data, model) device mesh, the sharded
inversion, the batch inversion of many scenes and the line-sharded streak
histograms. One program on one host, no process group
(:mod:`xsarsea_tpu_torch.parallel.mesh`)."""

from xsarsea_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from xsarsea_tpu_torch.parallel.inversion import sharded_invert_pixels  # noqa: F401
from xsarsea_tpu_torch.parallel.batch import invert_scenes  # noqa: F401
from xsarsea_tpu_torch.parallel.gradients import sharded_streaks_histogram  # noqa: F401

__all__ = ["Mesh", "make_mesh", "sharded_invert_pixels", "invert_scenes",
           "sharded_streaks_histogram"]
