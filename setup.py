"""Build script: native extensions only (metadata lives in pyproject.toml).

In-place build of the LUT codec, once for each package:
    python setup.py build_ext --inplace
Both packages work without it (pure-Python fallbacks are used).
"""

import numpy
from setuptools import Extension, setup

setup(
    ext_modules=[
        Extension(
            "xsarsea_tpu._lutio",
            sources=["native/lutio.cpp"],
            include_dirs=[numpy.get_include()],
            extra_compile_args=["-O3", "-std=c++17"],
            # pure-Python fallbacks exist: a missing C++ toolchain must
            # not make the package uninstallable from source
            optional=True,
        ),
        # the PyTorch port's copy of the same codec: it never imports xsarsea_tpu
        Extension(
            "xsarsea_tpu_torch._lutio",
            sources=["xsarsea_tpu_torch/native/lutio.cpp"],
            include_dirs=[numpy.get_include()],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,
        ),
    ],
)
