"""Operands that hit every seam of the K2/K3 slab sweep.

The sweep (``xs::slab::sweep`` in ``csrc/inversion_common.cuh``) splits a
128-pixel block's work: lane l of warp w owns the pixels ``l + 32 k``, warp
w sweeps the slab rows ``r = w (mod 4)`` in chunks of 8 rows, each row is
read as float4s with a scalar tail where the width is not a multiple of 4,
and a 32-pixel group whose s0 are all NaN is not swept. :func:`seam_cases`
builds direct-form operands (random, not from a GMF) whose answers depend
on each of those seams being joined right:

* exact cost ties (cost 0) between duplicated LUT/u/v cells in different
  warps, in different chunks, within one warp, within one float4, across
  float4s and between the last float4 and the scalar tail;
* blocks whose padding tail fills whole groups, ends mid-group, or leaves
  one pixel; a block whose every s0 is NaN; a NaN group before live ones;
  NaN-s0 pixels with valid crosspol features inside such groups;
* a NaN LUT entry, +-inf LUT entries met by s0 = +-inf and 1/dsig = 0,
  1/dsig = inf with s0 on and off the slab's values;
* a slab of padding rows only, where 1/dsig = 1e-3 ties every entry.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels
against their plain versions on them; ``tests/test_torch_slab_seams.py``
holds the plain versions against the JAX Pallas kernels and checks the
designed answers (:attr:`SeamCases.expected`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from xsarsea_tpu_torch.ops import inversion_kernels as K

__all__ = ["SeamCases", "TIE_ROW0", "seam_cases", "tie_sets"]

TIE_ROW0 = 16  # first LUT row of the tie blocks' slab


def tie_sets(n_phi, n_rows=K.SLAB_ROWS):
    """Cells (slab row, column) that hold one value each; a pixel placed on
    them ties at cost 0 and the lowest flat index must win. The slab holds
    ``n_rows`` rows, a multiple of 8 from 32 (the rows of its last chunk
    shift with it: 41, 40, 44, 47 at 48 rows; 25, 24, 28, 31 at 32, where
    the scalar tail's pair moves up to row 30 to leave the slab's last entry
    to the last set)."""
    if n_rows < 32 or n_rows % 8:
        raise ValueError(f"tie_sets: n_rows {n_rows} is not a multiple of 8 from 32")
    last = n_phi - 1
    end = n_rows - 1
    tail = min(31, end - 1)
    return [
        [(2, 10), (3, 10)],  # adjacent warps, one chunk
        [(3, 20), (4, 20)],  # the lower index in warp 3, the higher in warp 0
        [(7, 30), (8, 30)],  # across chunks
        [(9, 11), (13, 11)],  # one warp, one chunk
        [(17, 12), (end - 6, 12)],  # one warp, two chunks
        [(end - 7, 5), (21, 5), (22, 5)],  # three warps, two chunks
        [(30, 0), (30, 1)],  # one float4
        [(30, 3), (30, 4)],  # across float4s
        [(tail, last - 1), (tail, last)],  # the last float4 and the scalar tail
        [(5, last), (6, 0)],  # a row's tail and the next row's head
        [(end - 3, 7), (12, 7)],  # listed out of order
        [(end, last), (0, 0)],  # the slab's last and first entries
    ]


@dataclass
class SeamCases:
    """Raw tables (``lut``, ``u``, ``v``, ``wspd``, ``phir``, ``crlut``,
    ``crw``), the port's operands built from them, the per-block
    ``sband``/``srow0``/``vmask`` and the (n, 8) ``feats``, and
    ``n_rows``, the slab height to pass the kernels (``n_rows=``);
    ``expected``: slot -> K3's designed output for the slots whose answer
    the design fixes; ``crosspol_slots``, NaN-s0 slots whose crosspol is
    still solved."""

    lut: np.ndarray
    u: np.ndarray
    v: np.ndarray
    wspd: np.ndarray
    phir: np.ndarray
    crlut: np.ndarray
    crw: np.ndarray
    feats: np.ndarray
    sband: np.ndarray
    srow0: np.ndarray
    vmask: np.ndarray
    n_rows: int = K.SLAB_ROWS
    expected: dict = field(default_factory=dict)
    crosspol_slots: list = field(default_factory=list)

    @property
    def n_phi(self):
        return self.lut.shape[2]

    def k2_args(self, device):
        """Positional arguments of :func:`K.slab_refine_fused`."""
        lut_pad, u_half, v_half = K.build_direct_arrays(self.lut, self.u, self.v)
        ops = (lut_pad, u_half, v_half, K.build_decode_arrays(self.wspd, lut_pad.shape[1]),
               self.phir, *K.build_crosspol_arrays(self.crlut, self.crw), self.feats,
               self.sband, self.srow0, self.vmask)
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in ops)

    def k3_args(self, device):
        """Positional arguments of :func:`K.slab_refine`."""
        lut_pad, u_half, v_half = K.build_direct_arrays(self.lut, self.u, self.v)
        ops = (lut_pad, u_half, v_half, self.feats[:, :4], self.sband, self.srow0, self.vmask)
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in ops)

    def index(self, device):
        """The kernels' ``index``: the identity permutation, the rows being
        in slot order already, so K2's and K3's results come back in slot
        order."""
        return torch.arange(self.feats.shape[0], device=device)


def seam_cases(n_phi=181, n_wspd=70, n_cr=90, seed=0, n_rows=K.SLAB_ROWS):
    """The adversarial block set at width ``n_phi`` and slab height
    ``n_rows`` (see the module docstring); 14 blocks of ``K.SLAB_BLOCK``
    pixels. The tie cells need ``n_phi >= 32`` and ``n_wspd >= 16 +
    n_rows``."""
    sets = tie_sets(n_phi, n_rows)
    if n_phi < 32 or n_wspd < TIE_ROW0 + n_rows:
        raise ValueError(f"seam_cases: n_phi {n_phi} < 32 or n_wspd {n_wspd} < "
                         f"{TIE_ROW0 + n_rows}")
    rng = np.random.default_rng(seed)
    bs = K.SLAB_BLOCK
    n_inc = 3
    wspd = np.linspace(0.2, 50, n_wspd).astype(np.float32)
    phir = np.deg2rad(np.linspace(0, 180, n_phi)).astype(np.float32)
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np.float32)
    for cells in sets:  # one value per set, in every band
        (r1, c1), rest = cells[0], cells[1:]
        for r, c in rest:
            lut[:, TIE_ROW0 + r, c] = lut[:, TIE_ROW0 + r1, c1]
            u[TIE_ROW0 + r, c] = u[TIE_ROW0 + r1, c1]
            v[TIE_ROW0 + r, c] = v[TIE_ROW0 + r1, c1]
    lut[1, 40, 3] = np.inf
    lut[1, 41, 7] = -np.inf
    lut[2, 30, 9] = np.nan
    crlut = rng.uniform(-40, -20, (n_inc, n_cr)).astype(np.float32)
    crw = np.linspace(3, 80, n_cr).astype(np.float32)
    wp = K.build_direct_arrays(lut, u, v)[0].shape[1]

    # (band, srow0) per block; see the comments of each block below
    layout = [(0, 0), (0, TIE_ROW0), (1, TIE_ROW0), (2, TIE_ROW0), (2, 48),
              (0, wp - n_rows), (0, 0), (1, 0), (2, 48), (0, TIE_ROW0), (1, 0), (0, 0),
              (0, 0), (0, TIE_ROW0)]
    nb = len(layout)
    sband = np.array([b for b, _ in layout], np.int32)
    srow0 = np.array([r for _, r in layout], np.int32)
    vmask = np.ones(nb, np.int32)
    n = nb * bs
    feats = np.stack([rng.uniform(-35, 0, n), rng.uniform(-6, 6, n), rng.uniform(0, 6, n),
                      np.full(n, 10.0), rng.uniform(-38, -22, n), rng.uniform(0.1, 1.0, n),
                      np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    no_hit = K._no_hit_flat(n_phi)
    expected = {}
    crosspol_slots = []

    def slot(b, p):
        return b * bs + p

    def on_cell(s, band, r, c):
        feats[s, :4] = lut[band, r, c], u[r, c] * 0.5, v[r, c] * 0.5, 10.0

    def pad(b, lo, hi=bs):  # padding slots: every feature NaN
        feats[slot(b, lo):slot(b, hi)] = np.nan

    def winner(cells):
        return min((TIE_ROW0 + r) * n_phi + c for r, c in cells)

    # 1: every tie set, each at four pixels of four groups
    for i, cells in enumerate(sets):
        for g in range(4):
            s = slot(1, 32 * g + (7 * i + g) % 32)
            r, c = cells[g % len(cells)]
            on_cell(s, 0, TIE_ROW0 + r, c)
            expected[s] = winner(cells)
    # 2: band 1 holds +inf and -inf entries in the slab
    b2 = slot(2, 0)
    feats[b2 + 0, 3] = 0.0  # inf * 0: NaN
    feats[b2 + 1, 0] = np.inf  # inf - inf: NaN
    feats[b2 + 2, 0] = -np.inf  # -inf - -inf: NaN
    feats[b2 + 3, :4] = lut[1, 20, 5], 1.0, 1.0, np.inf  # (l - s0) = 0 times inf: NaN
    feats[b2 + 4, :4] = 1000.5, 1.0, 1.0, np.inf  # every cost inf: no hit
    for k in range(4):
        expected[b2 + k] = K._NAN_IDX
    expected[b2 + 4] = no_hit
    # 3: a NaN LUT entry in the slab poisons every pixel
    for p in range(bs):
        expected[slot(3, p)] = K._NAN_IDX
    # 4: a slab straddling the last true row (band 2's NaN lies above it)
    # 5: a slab of padding rows only: no hit at 1/dsig = 10; at 1e-3 every
    #    entry ties and the first wins
    feats[slot(5, 64):slot(5, 128), 3] = 1e-3
    for p in range(bs):
        expected[slot(5, p)] = no_hit if p < 64 else (wp - n_rows) * n_phi
    # 6-9: padding tails of 88, 64, 127 and 1 slots (whole groups, mid-group)
    for b, live in ((6, 40), (7, 64), (8, 1), (9, 127)):
        pad(b, live)
        for p in range(live, bs):
            expected[slot(b, p)] = K._NAN_IDX
    # a NaN-s0 pixel with valid crosspol features in a group that is not swept
    feats[slot(6, 100), :4] = np.nan
    feats[slot(6, 100), 4:6] = -30.0, 0.5
    crosspol_slots.append(slot(6, 100))
    # 9: its live pixels on tie cells
    for i, cells in enumerate(sets):
        s = slot(9, 3 * i)
        r, c = cells[-1]
        on_cell(s, 0, TIE_ROW0 + r, c)
        expected[s] = winner(cells)
    # 10: every s0 NaN but the block is not padding (no group swept);
    #     its crosspol is solved
    feats[slot(10, 0):slot(11, 0), 0] = np.nan
    for p in range(bs):
        expected[slot(10, p)] = K._NAN_IDX
    crosspol_slots += [slot(10, 0), slot(10, 77), slot(10, 127)]
    # 11: group 1 all NaN s0, groups 0, 2, 3 live
    feats[slot(11, 32):slot(11, 64), 0] = np.nan
    for p in range(32, 64):
        expected[slot(11, p)] = K._NAN_IDX
    crosspol_slots.append(slot(11, 40))
    # 12: all padding, skipped (vmask 0)
    pad(12, 0)
    vmask[12] = 0
    # 13: groups 0 and 2 padding, ties in groups 1 and 3
    pad(13, 0, 32)
    pad(13, 64, 96)
    for i, cells in enumerate(sets):
        for g in (1, 3):
            s = slot(13, 32 * g + i)
            r, c = cells[0]
            on_cell(s, 0, TIE_ROW0 + r, c)
            expected[s] = winner(cells)
    return SeamCases(lut=lut, u=u, v=v, wspd=wspd, phir=phir, crlut=crlut, crw=crw,
                     feats=feats, sband=sband, srow0=srow0, vmask=vmask, n_rows=n_rows,
                     expected=expected, crosspol_slots=crosspol_slots)
