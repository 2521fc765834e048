"""The benchmark of xsarsea_tpu_torch: dual-pol wind inversion cells on one
card, driven by ``BENCHMARK.json`` and the data files beside this package."""
