"""The inversion's work and its least time on the card, counted from a
cell's shapes and the fused algorithm's frozen constants, never from the
arguments the program passes to its kernels.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 67 TFLOP/s
FP32 outside the tensor cores, 3.35 TB/s of HBM3. An FMA counts two
operations, and the costs are summed without contraction (the port's
kernels are bit-equal to plain float32 arithmetic), so no share of these
kernels can pass 50%.

The fused algorithm (``xsarsea_tpu_torch/windspeed/inversion.py:85-87``,
``ops/inversion_kernels.py:98-100``; the values xsarsea_tpu tuned): a coarse
pass on the LUT rows ``arange(0, W, stride_w) | {W-1}`` and columns
``arange(0, P, stride_p) | {P-1}`` with ``stride_w = round(0.8 m/s / wspd
step)`` and ``stride_p = round(4 deg / phi step)``, its minimum kept per group
of 16 rows; then a slab of 16 + 2 * 16 = 48 rows by all P columns around the
winning group; then the crosspol speeds of the pixel's crosspol row.
"""

from __future__ import annotations

import numpy as np

PEAK_FP32 = 67e12  # FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s
COARSE_DW = 0.8  # m/s
COARSE_DPHI = 4.0  # deg
WGROUP = 16  # LUT rows a group
SLAB_MARGIN = 16  # rows each side of the group
SLAB_ROWS = WGROUP + 2 * SLAB_MARGIN
OPS_COST = 10  # a copol cost entry: 3 sub, 4 mul, 2 add, the compare that keeps the least
OPS_CROSSPOL = 8  # a crosspol entry: 2 sub, div, 3 mul, add, compare
F32 = 4


def coarse_grid(n_wspd, n_phi, wspd_step, phi_step):
    """(rows, columns) of the coarse pass."""
    sw = max(1, round(COARSE_DW / wspd_step))
    sp = max(1, round(COARSE_DPHI / phi_step))
    rows = np.unique(np.r_[np.arange(0, n_wspd, sw), n_wspd - 1]).size
    cols = np.unique(np.r_[np.arange(0, n_phi, sp), n_phi - 1]).size
    return int(rows), int(cols)


class Work:
    """Per-call operations and bytes of the two kernel layers for a
    configuration's table shapes: ``co`` (incidence, wspd, phi) with its
    steps, ``n_cr_wspd`` crosspol speeds, ``fused_tail`` whether crosspol
    shares the copol incidence axis (one refine kernel with the crosspol tail)
    or has its own (refine, then a crosspol pass)."""

    def __init__(self, co_shape, wspd_step, phi_step, n_cr_inc, n_cr_wspd, fused_tail):
        self.n_inc, self.n_wspd, self.n_phi = co_shape
        self.rows, self.cols = coarse_grid(self.n_wspd, self.n_phi, wspd_step, phi_step)
        self.n_cr_inc, self.n_cr_wspd = n_cr_inc, n_cr_wspd
        self.fused_tail = fused_tail

    def coarse(self, live_co):
        """(operations, bytes) of one call's coarse pass."""
        grid = self.rows * self.cols
        ops = live_co * grid * OPS_COST
        table = (self.n_inc * grid + 2 * grid + self.rows) * F32
        return ops, table + live_co * (4 + 1) * F32  # 4 features in, the group out

    def refine(self, live_co, live_cr):
        """(operations, bytes) of one call's slab refine and crosspol pass."""
        ops = live_co * SLAB_ROWS * self.n_phi * OPS_COST + live_cr * self.n_cr_wspd * OPS_CROSSPOL
        table = (self.n_inc * self.n_wspd * self.n_phi + 2 * self.n_wspd * self.n_phi
                 + self.n_cr_inc * self.n_cr_wspd) * F32
        if self.fused_tail:  # 8 features in; speed, direction, dual speed out
            per_px = live_co * (8 + 3) * F32
        else:  # 4 features in, the cell's index out; 4 in, the dual speed out
            per_px = live_co * (4 + 1) * F32 + live_cr * (4 + 1) * F32
        return ops, table + per_px


def bound_s(ops, n_bytes):
    """The least time the card could take: the larger of the two."""
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)
