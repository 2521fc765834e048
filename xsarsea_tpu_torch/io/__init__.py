"""I/O: LUT serialization (counterpart of ``xsarsea_tpu.io``)."""
