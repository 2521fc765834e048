"""Operands that hit every seam of K1's coarse sweep and of the crosspol
argmin (K4's body, K2's tail).

K1 (``csrc/group_argmin.cu``) splits a 256-pixel block's work: two pixel
sets of 128, lane l of a set's warps owning the pixels ``l + 32 k``, the
wind-speed groups dealt to ``K1_CHAINS`` chains by ``group % K1_CHAINS``
and merged by (minimum, group), rows read as float4s up to a stride padded
with NaN, 32-pixel groups whose s0 are all NaN not swept.
:func:`coarse_seam_cases` builds coarse operands (random, not from a GMF)
whose answers depend on each of those seams being joined right:

* equal group minima (cost 0 on duplicated cells) in groups of different
  chains, with the higher group in the lower chain, in one chain and in one
  group, in every 32-pixel group of both pixel sets: the lowest group wins;
* the minimum in each position of a float4 and in the last real column,
  beside the stride's NaN padding where the width has one;
* NaN LUT entries, a NaN row and a NaN group, which neither win nor poison;
* a pixel of NaN features, a pixel whose every cost is +inf and a pixel of
  a band whose only finite costs lie in the last group (all three get the
  last group), a band whose only finite cost lies in group 0;
* blocks whose padding fills whole 32-pixel groups, a lone live pixel, a
  block of padding only, NaN groups between live ones;
* groups of one, two and three rows, the last group a single row.

The crosspol loop (``xs::crosspol::argmin``) reads the band's row as float4s
with a scalar tail, reduces a float4's costs before one compare, hoists the
divide when a pixel's ``dsig_cr`` and ``s0_cr`` allow it, and skips 32-pixel
groups whose ``s0_cr`` are all NaN. :func:`crosspol_seam_cases` (K4) and
:func:`fused_crosspol_seam_cases` (K2, on the slab sweep's seam blocks)
build rows with exact cost ties inside one float4, across float4s, between
the last float4 and the tail, at the first and last entry, with and without
the copol prior; a NaN and infinite LUT entries; NaN, zero, infinite, tiny,
huge and negative ``dsig_cr``; NaN, zero and huge ``s0_cr``; a wind-speed
row that does not ascend; padding groups.

:func:`quotient_random_set` and :func:`quotient_edge_set` are the operand
pairs on which the hoisted quotient
(``experiment_kernels.crosspol_quotient``) is held against the true divide
on the card.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels against
their plain versions on these cases; ``tests/test_torch_coarse_seams.py``
holds the plain versions against the JAX package and checks the designed
answers (``expected``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.slab_seams import seam_cases

__all__ = ["CoarseSeamCases", "CrosspolSeamCases", "K1_CHAINS", "K1_SET_PIXELS",
           "coarse_row_group", "coarse_seam_cases", "coarse_tie_sets", "crosspol_seam_cases",
           "full_grid_seam_cases", "prune_seam_cases",
           "crosspol_tie_sets", "fused_crosspol_seam_cases", "quotient_edge_set",
           "quotient_random_set"]

K1_CHAINS = 4  # group chains per pixel set: kChains of group_argmin.cu
K1_SET_PIXELS = 128  # pixels per set, 4 a thread: kSetPixels of group_argmin.cu
N_GROUPS = 32
_GROUP_ROWS = {5: 3, 6: 1, N_GROUPS - 1: 1}  # every other group holds two rows


def coarse_row_group():
    """The seam grid's group per coarse row: 63 rows in 32 groups."""
    return np.repeat(np.arange(N_GROUPS), [_GROUP_ROWS.get(g, 2) for g in range(N_GROUPS)]) \
        .astype(np.int32)


def _row(row_group, g, i=0):
    return int(np.nonzero(row_group == g)[0][i])


def coarse_tie_sets(n_cols):
    """Cells (group, row within the group, column) that hold one value
    each; a pixel placed on them ties at cost 0 and the lowest group must
    win."""
    last = n_cols - 1
    return [
        [(9, 0, 10), (14, 1, 10)],  # chains 1 and 2
        [(11, 1, 3), (12, 0, 4)],  # the lower group in chain 3, the higher in chain 0
        [(3, 0, 7), (19, 1, 6)],  # one chain
        [(20, 0, 12), (20, 1, 13)],  # one group
        [(28, 0, last), (13, 0, 0), (22, 1, 5)],  # three chains, listed out of order
        [(5, 2, 2), (6, 0, 2)],  # a three-row group and a one-row group
        [(30, 1, last - 1), (N_GROUPS - 1, 0, last)],  # the last group's single row
        [(0, 0, 0), (4, 0, 1)],  # the first entry, one chain
    ]


@dataclass
class CoarseSeamCases:
    """K1's operands (``lut_c`` (I, R, C), ``u_half``/``v_half`` (R, C),
    ``row_group``), ``feats`` (n, 4), ``band_of_block`` and ``expected``:
    slot -> the designed group."""

    lut_c: np.ndarray
    u_half: np.ndarray
    v_half: np.ndarray
    row_group: np.ndarray
    feats: np.ndarray
    band_of_block: np.ndarray
    n_groups: int = N_GROUPS
    expected: dict = field(default_factory=dict)
    exact_lb: tuple = None  # prune seams: (slot, group, cost) of a best equal to a bound

    def args(self, device):
        """Positional arguments of :func:`K.group_argmin`."""
        ops = (self.lut_c, self.u_half, self.v_half, self.row_group, self.feats,
               self.band_of_block)
        return (*(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in ops),
                self.n_groups)

    def index(self, device):
        """The kernels' ``index``: the identity permutation (the rows are in
        slot order already)."""
        return torch.arange(self.feats.shape[0], device=device)

    def radii(self, device):
        """The grid's chunk annuli, the ``radii`` of
        :func:`K.group_argmin_streamed` (:func:`K.build_chunk_radii`)."""
        return torch.as_tensor(K.build_chunk_radii(self.u_half, self.v_half), device=device)


def coarse_seam_cases(n_cols=46, seed=0):
    """K1's adversarial block set at width ``n_cols`` >= 16 (see the module
    docstring); 10 blocks of ``K.GROUP_BLOCK`` pixels on 4 bands."""
    if n_cols < 16:
        raise ValueError(f"coarse_seam_cases: n_cols {n_cols} < 16")
    rng = np.random.default_rng(seed)
    bs = K.GROUP_BLOCK
    row_group = coarse_row_group()
    n_rows = row_group.shape[0]
    last_g = N_GROUPS - 1
    lut_c = rng.uniform(-35, 0, (4, n_rows, n_cols)).astype(np.float32)
    u_half = rng.uniform(-12, 12, (n_rows, n_cols)).astype(np.float32)
    v_half = rng.uniform(0, 12, (n_rows, n_cols)).astype(np.float32)
    sets = [[(_row(row_group, g, i), c) for g, i, c in cells] for cells in
            coarse_tie_sets(n_cols)]
    for cells in sets:  # one value per set, in every band
        (r1, c1), rest = cells[0], cells[1:]
        for r, c in rest:
            lut_c[:, r, c] = lut_c[:, r1, c1]
            u_half[r, c] = u_half[r1, c1]
            v_half[r, c] = v_half[r1, c1]
    # band 1: NaN entries beside the cells pixels sit on, a NaN row, a NaN group
    nan_cells = [(_row(row_group, 7), 8), (_row(row_group, 7), 10), (_row(row_group, 16, 1), 0),
                 (_row(row_group, 2), n_cols - 1)]
    for r, c in nan_cells:
        lut_c[1, r, c] = np.nan
    lut_c[1, _row(row_group, 18, 1)] = np.nan
    lut_c[1, row_group == 25] = np.nan
    # band 2: finite costs in the last group's row only; band 3: in one cell of group 0
    lut_c[2, : n_rows - 1] = np.inf
    keep = lut_c[3, 1, 5]
    lut_c[3] = -np.inf
    lut_c[3, 1, 5] = keep

    band_of_block = np.array([0, 0, 1, 2, 3, 0, 0, 0, 0, 0], np.int32)
    n = band_of_block.shape[0] * bs
    feats = np.stack([rng.uniform(-35, 0, n), rng.uniform(-12, 12, n), rng.uniform(0, 12, n),
                      np.full(n, 10.0)], 1).astype(np.float32)
    expected = {}

    def slot(b, p):
        return b * bs + p

    def on_cell(s, band, r, c):
        feats[s] = lut_c[band, r, c], u_half[r, c], v_half[r, c], 10.0

    def pad(b, lo, hi=bs):  # padding slots: every feature NaN
        feats[slot(b, lo):slot(b, hi)] = np.nan

    def winner(cells):
        return int(min(row_group[r] for r, _ in cells))

    # 0: every tie set in each 32-pixel group of both pixel sets, from each of its cells
    for i, cells in enumerate(sets):
        for g in range(bs // 32):
            s = slot(0, 32 * g + (5 * i + g) % 32)
            on_cell(s, 0, *cells[g % len(cells)])
            expected[s] = winner(cells)
    # 1: the minimum in each position of two float4s and in the last columns
    r17 = _row(row_group, 17)
    for i, c in enumerate([*range(8, 16), *range(n_cols - 4, n_cols)]):
        for p in (i, K1_SET_PIXELS + 40 + i):
            on_cell(slot(1, p), 0, r17, c)
            expected[slot(1, p)] = 17
    # 2: band 1's NaN entries neither win nor poison
    on_cell(slot(2, 0), 1, _row(row_group, 7), 9)  # between two NaN cells
    expected[slot(2, 0)] = 7
    on_cell(slot(2, 33), 1, _row(row_group, 18, 0), 4)  # the group's other row is NaN
    expected[slot(2, 33)] = 18
    on_cell(slot(2, 200), 1, _row(row_group, 24, 1), 6)  # below the NaN group
    expected[slot(2, 200)] = 24
    on_cell(slot(2, 201), 1, _row(row_group, 2), n_cols - 2)  # beside a NaN last column
    expected[slot(2, 201)] = 2
    # 3: the only finite costs lie in the last group; 4: in group 0
    for p in range(bs):
        expected[slot(3, p)] = last_g
        expected[slot(4, p)] = 0
    # 5: pixels with no finite cost, for three reasons
    feats[slot(5, 3)] = np.nan
    feats[slot(5, 4), 3] = np.inf  # every cost +inf
    feats[slot(5, 5), 1] = np.nan  # a NaN ancillary: every cost NaN, in a group that is swept
    feats[slot(5, 130), 0] = np.nan  # no copol sigma0
    for p in (3, 4, 5, 130):
        expected[slot(5, p)] = last_g
    # 6: one live 32-pixel group; 7: a lone live pixel; 8: padding only
    pad(6, 32)
    pad(7, 0, 200)
    pad(7, 201)
    on_cell(slot(7, 200), 0, *sets[0][1])
    expected[slot(7, 200)] = winner(sets[0])
    pad(8, 0)
    for b, live in ((6, range(32)), (7, [200]), (8, [])):
        for p in set(range(bs)) - set(live):
            expected[slot(b, p)] = last_g
    # 9: NaN groups between live ones in both sets, ties in the live groups
    pad(9, 32, 64)
    pad(9, K1_SET_PIXELS + 64, K1_SET_PIXELS + 96)
    for p in [*range(32, 64), *range(K1_SET_PIXELS + 64, K1_SET_PIXELS + 96)]:
        expected[slot(9, p)] = last_g
    for i, cells in enumerate(sets):
        for g in (0, 2, 3, 4, 5, 7):
            s = slot(9, 32 * g + i)
            on_cell(s, 0, *cells[-1])
            expected[s] = winner(cells)
    return CoarseSeamCases(lut_c=lut_c, u_half=u_half, v_half=v_half, row_group=row_group,
                           feats=feats, band_of_block=band_of_block, expected=expected)


# ---------------------------------------------------- K1 on the full grid

def full_grid_seam_cases(n_cols=181, seed=0):
    """:func:`coarse_seam_cases` lifted to a full grid for K1's streamed
    form (rows of group g at ``16 g .. 16 g + 15``, 499 rows): each seam
    group's rows open its 16-row group, the other rows of the group repeat
    the first one's wind components with NaN LUT values (never winning), so
    every designed answer stands."""
    c = coarse_seam_cases(n_cols, seed)
    n_rows = K.WGROUP * (N_GROUPS - 1) + 3
    n_inc = c.lut_c.shape[0]
    lut = np.full((n_inc, n_rows, n_cols), np.nan, np.float32)
    u = np.empty((n_rows, n_cols), np.float32)
    v = np.empty((n_rows, n_cols), np.float32)
    for g in range(N_GROUPS):
        src = np.nonzero(c.row_group == g)[0]
        top = K.WGROUP * g
        rows = min(K.WGROUP, n_rows - top)
        lut[:, top:top + src.size] = c.lut_c[:, src]
        u[top:top + rows] = c.u_half[src[0]]
        v[top:top + rows] = c.v_half[src[0]]
        u[top:top + src.size] = c.u_half[src]
        v[top:top + src.size] = c.v_half[src]
    return CoarseSeamCases(lut_c=lut, u_half=u, v_half=v,
                           row_group=(np.arange(n_rows) // K.WGROUP).astype(np.int32),
                           feats=c.feats, band_of_block=c.band_of_block, expected=c.expected)


def _structured_grid(n_cols):
    """The full grid's shape with a GMF-like layout: speeds 0.2-50 m/s by
    0.1 over 499 rows, directions 0-180 deg over ``n_cols`` columns, u/2 and
    v/2 on the speed's half-circle, and two smooth LUT bands (dB)."""
    w = (0.2 + 0.1 * np.arange(499)).astype(np.float32)
    phi = np.linspace(0.0, np.pi, n_cols)
    u = (w[:, None] * np.cos(phi)[None, :] * 0.5).astype(np.float32)
    v = (w[:, None] * np.sin(phi)[None, :] * 0.5).astype(np.float32)
    base = -28.0 + 12.0 * np.log10(w)[:, None] + 2.0 * np.cos(2 * phi)[None, :]
    return np.stack([base, base + 1.0]).astype(np.float32), u, v


def _cell_near(u, v, x, y):
    """The grid cell whose (u/2, v/2) lies nearest (x, y)."""
    d = (u.astype(np.float64) - x) ** 2 + (v.astype(np.float64) - y) ** 2
    return np.unravel_index(int(np.argmin(d)), d.shape)


def prune_seam_cases(n_cols=181, seed=0):
    """Operands for the streamed K1's pruning (csrc/group_argmin.cu) on a
    structured 499 x ``n_cols`` grid (:func:`_structured_grid`). Designed
    pixels have s0 = 0 dB and 1/dsig = 1024, far from every LUT value, so
    that only cells whose LUT value was set for them can win:

    * exact ties between a home group and a later one, and between a home
      group and an earlier one (visited after it): cost 0.25 on cells of
      groups 3 and 4 (the lower wins);
    * a pixel whose best cost equals another group's lower bound exactly
      (that group is kept: ``lb <= best`` is not strict);
    * a group whose band-1 LUT values are all NaN, holding the prior of a
      pixel (its home sweep finds nothing), and a NaN row;
    * random pixels on the grid, in blocks sorted by their prior's radius and
      in one block that is not, with pixels at radius 0, a denormal prior, a
      prior of 1e30 and 1e-30, 1/dsig of 1e6 and 1e-6, an infinite 1/dsig
      (every cost +inf or NaN), NaN s0 and a NaN prior, and padding.

    ``expected``: slot -> the designed group. ``exact_lb``: the slot of the
    pixel whose best equals a bound, the group of that bound and the cost.
    The first three blocks hold the designed pixels (1/dsig 1024, s0 0 dB),
    the rest random ones."""
    rng = np.random.default_rng(seed)
    bs = K.GROUP_BLOCK
    lut, u, v = _structured_grid(n_cols)
    n_rows = u.shape[0]
    row_group = (np.arange(n_rows) // K.WGROUP).astype(np.int32)
    n_groups = int(row_group[-1]) + 1
    lut[1, K.WGROUP * 10:K.WGROUP * 11] = np.nan  # an all-NaN group in band 1
    lut[1, 300] = np.nan  # a NaN row
    # the designed pixels' blocks: the ties (band 0), the exact bound alone
    # (band 0), the all-NaN group (band 1)
    feats_d = np.full((3 * bs, 4), np.nan, np.float32)
    expected = {}

    def put(slot, ma2, mz2, group):
        feats_d[slot] = 0.0, ma2, mz2, 1024.0
        expected[slot] = group

    def set_cell(cell, x, y, l):
        u[cell], v[cell] = x, y
        lut[0, cell[0], cell[1]] = l

    # ties at cost 0.25 = 0.5^2, once through t1 = ((l - 0) * 1024)^2, once
    # through t2: the prior (3.0, 0) lies in group 3's annulus only, (3.5,
    # 0.5) in group 4's only
    cells = [_cell_near(u, v, x, y) for x, y in ((3.0, 0.4), (3.5, 0.4), (3.0, 0.8), (3.5, 0.8))]
    assert [int(row_group[c[0]]) for c in cells] == [3, 4, 3, 4]
    set_cell(cells[0], 3.0, 0.0, 0.5 / 1024)
    set_cell(cells[1], 3.5, 0.0, 0.0)
    set_cell(cells[2], 3.0, 0.5, 0.0)
    set_cell(cells[3], 3.5, 0.5, 0.5 / 1024)
    put(0, 3.0, 0.0, 3)  # home 3; the later group 4 ties
    put(40, 3.5, 0.5, 3)  # home 4; the earlier group 3, visited after it, ties

    # best cost equal to group 13's bound: the prior sits on a cell of group
    # 12 (t2 = t3 = 0), whose LUT value y / 1024 gives t1 = fl(y^2) = L =
    # lb(p, 13)
    radii = torch.as_tensor(K.build_chunk_radii(u, v))

    def squares(r, c):
        """(r, c, y, L) for each float y with fl(y^2) = L = lb(p, 13)."""
        f = torch.tensor([[0.0, u[r, c], v[r, c], 1.0]], dtype=torch.float32)
        lb = np.float32(K.chunk_lower_bounds(f, radii)[0, 13].item())
        y = np.float32(np.sqrt(lb))
        for cand in (y, np.nextafter(y, np.float32(0)), np.nextafter(y, np.float32(1))):
            if lb > 0 and np.float32(cand * cand) == lb:
                yield r, c, cand, lb

    r, c, y, lb = next(hit for r in range(12 * K.WGROUP, 13 * K.WGROUP)
                       for c in range(0, n_cols, 7) for hit in squares(r, c))
    lut[0, r, c] = y / np.float32(1024)
    put(bs, u[r, c], v[r, c], 12)

    # a prior in band 1's all-NaN group 10; its designed cell in group 11
    p10 = _cell_near(u, v, 8.35, 0.0)
    c11 = _cell_near(u, v, 9.1, 1.0)
    assert row_group[p10[0]] == 10 and row_group[c11[0]] == 11
    lut[1, c11[0], c11[1]] = 0.0
    put(2 * bs, u[p10], v[p10], 11)

    # random pixels: s0 a cell's LUT value, the prior that cell's components
    # plus noise; four blocks a band sorted by the prior's radius, one not
    def random_block(band, n=bs):
        cells = (rng.integers(0, n_rows, n), rng.integers(0, n_cols, n))
        noise = rng.normal(0, 0.75, (n, 2))
        return np.stack([lut[band][cells] + rng.normal(0, 0.05, n), u[cells] + noise[:, 0],
                         np.abs(v[cells] + noise[:, 1]), np.full(n, 10.0)], 1).astype(np.float32)

    blocks, block_band = [feats_d], [0, 0, 1]
    for band in (0, 1):
        px = random_block(band, 4 * bs)
        px = px[np.argsort(np.hypot(px[:, 1], px[:, 2]), kind="stable")]
        blocks += [px[k * bs:(k + 1) * bs] for k in range(4)]
        block_band += [band] * 4
    odd = random_block(0)  # unsorted, with the special pixels
    specials = [(0.0, 0.0), (1e-40, 1e-40), (1e30, 1e30), (1e-30, 1e-30), (np.nan, 1.0),
                (1.0, np.nan)]  # priors (ma/2, mz/2)
    for k, prior in enumerate(specials):
        odd[3 * k, 1:3] = prior
    odd[40, 3], odd[41, 3], odd[42, 3] = 1e6, 1e-6, np.inf
    odd[43, 0] = np.nan
    odd[44, 1] = np.nan
    odd[200:] = np.nan  # padding
    blocks.append(odd)
    block_band.append(0)
    feats = np.concatenate(blocks).astype(np.float32)
    return CoarseSeamCases(lut_c=lut, u_half=u, v_half=v, row_group=row_group, feats=feats,
                           band_of_block=np.array(block_band, np.int32), n_groups=n_groups,
                           expected=expected, exact_lb=(bs, 13, float(lb)))


# ------------------------------------------------------------------ crosspol

def crosspol_tie_sets(n_cr):
    """Entries of a crosspol row that hold one LUT value each: a pixel whose
    s0_cr is that value, with no copol prior, ties at cost 0 and the first
    entry must win. Widths with ``n_cr % 4`` of 0 or 3."""
    if n_cr < 64 or n_cr % 4 in (1, 2):
        raise ValueError(f"crosspol_tie_sets: n_cr {n_cr} < 64 or n_cr % 4 in (1, 2)")
    tail = n_cr - n_cr % 4
    last = n_cr - 1
    return [
        [0, 1],  # the first entry, one float4
        [3, 4],  # across float4s
        [6, 13, 22],  # three float4s
        [48, 49, 50, 51],  # a whole float4
        # the last float4 and the scalar tail, or across the last two float4s
        [tail - 1, tail] if tail < n_cr else [n_cr - 5, n_cr - 4],
        [last - 1, last],  # the last entry: in the tail, or in the last float4
    ]


def _crosspol_table(n_cr, rng):
    """A 3-band crosspol LUT whose entries lie 20 / n_cr dB apart (shuffled),
    so that no entry but a tie set's comes near a tie's cost, with the tie
    sets' duplicates in every band, +-inf entries in band 0, a NaN entry in
    band 2; and wind speeds on a dyadic grid (midpoints exact) that swap two
    entries, so the row does not ascend."""
    sets = crosspol_tie_sets(n_cr)
    lut = np.stack([-40.0 + 20.0 * rng.permutation(n_cr) / n_cr for _ in range(3)]) \
        .astype(np.float32)
    for cells in sets:
        lut[:, cells[1:]] = lut[:, cells[:1]]
    lut[0, 37] = np.inf
    lut[0, 41] = -np.inf
    lut[2, 29] = np.nan
    crw = (3.0 + 0.125 * np.arange(n_cr)).astype(np.float32)
    crw[[33, 45]] = crw[[45, 33]]
    return lut, crw, sets


@dataclass
class CrosspolSeamCases:
    """K4's operands from the raw ``crlut`` (I, Wc) and ``crw`` (Wc,),
    ``feats`` (n, 4), ``band_of_block`` and ``expected``: slot -> the
    designed wind speed."""

    crlut: np.ndarray
    crw: np.ndarray
    feats: np.ndarray
    band_of_block: np.ndarray
    expected: dict = field(default_factory=dict)

    def args(self, device):
        """Positional arguments of :func:`K.crosspol_argmin`."""
        ops = (*K.build_crosspol_arrays(self.crlut, self.crw), self.feats, self.band_of_block)
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in ops)

    def index(self, device):
        """The kernel's ``index``: the identity permutation, so K4's speeds
        come back in slot order."""
        return torch.arange(self.feats.shape[0], device=device)


# dsig_cr values of the seam pixels: the usual ones, the hoisted quotient's
# window edges and both sides of them, zero, tiny, huge, infinite, negative
# (no denormal: XLA's CPU backend, which runs the reference kernels in the
# tests, flushes them to zero; tests/test_torch_cuda.py divides by them)
_DSIGS = (0.1, 0.3, 1.0, 2.0 ** -20, 2.0 ** 20, 2.0 ** -21, 2.0 ** 21, 0.0, 1e-30, 1e30,
          np.inf, -0.3, -np.inf)
# s0_cr values beside the LUT's own: zero and tiny (below the hoisted window),
# huge (the quotient overflows) and infinite
_S0S = (0.0, -0.0, 2.0 ** -11, 1e-30, -3e38, 1e30, np.inf, -np.inf)


def crosspol_seam_cases(n_cr=155, seed=0):
    """K4's adversarial block set at width ``n_cr`` (see the module
    docstring); 8 blocks of ``K.CR_BLOCK`` pixels on 3 bands."""
    rng = np.random.default_rng(seed)
    bs = K.CR_BLOCK
    lut, crw, sets = _crosspol_table(n_cr, rng)
    w_half = crw * np.float32(0.5)
    band_of_block = np.array([1, 1, 0, 2, 1, 1, 1, 0], np.int32)
    n = band_of_block.shape[0] * bs
    has_co = (rng.random(n) < 0.7).astype(np.float32)
    feats = np.stack([rng.uniform(-40, -20, n), rng.choice([0.1, 0.3, 1.0], n),
                      has_co * rng.uniform(1.5, 40, n), has_co], 1).astype(np.float32)
    expected = {}

    def slot(b, p):
        return b * bs + p

    def pad(b, lo, hi=bs):
        feats[slot(b, lo):slot(b, hi)] = np.nan

    # 0: every tie set with no prior, from each of its entries, at three dsig;
    #    then its pairs under a prior midway between their two speeds (the
    #    nearest other LUT value costs (20 / n_cr / dsig)^2, above the pair's)
    p = 0
    for cells in sets:
        for k in cells:
            for dsig in (0.1, 0.3, 1.0):
                feats[slot(0, p)] = lut[1, k], dsig, 0.0, 0.0
                expected[slot(0, p)] = float(crw[cells[0]])
                p += 1
    for k1, k2 in (cells for cells in sets if len(cells) == 2):
        for dsig in (0.1, 0.3):
            mid = (w_half[k1] + w_half[k2]) * np.float32(0.5)  # exact on the dyadic grid
            feats[slot(0, p)] = lut[1, k1], dsig, mid, 1.0
            expected[slot(0, p)] = float(crw[k1])
            p += 1
    # 1: every dsig of the list, on an entry and off every entry, with and without a prior
    p = 0
    for dsig in _DSIGS:
        for s0 in (lut[1, 60], np.float32(-30.013)):
            for has in (0.0, 1.0):
                feats[slot(1, p)] = s0, dsig, has * w_half[20], has
                p += 1
    for s0 in _S0S:
        for dsig in (0.1, 2.0 ** -20, 2.0 ** 20):
            feats[slot(1, p)] = s0, dsig, 0.0, 0.0
            p += 1
    feats[slot(1, p), 0] = np.nan  # no crosspol sigma0
    feats[slot(1, p + 1), 1] = np.nan
    feats[slot(1, p + 2), 2] = np.nan
    for k in range(3):
        expected[slot(1, p + k)] = 0.0
    # designed among them (no prior): dsig = 0 off every entry leaves +inf
    # costs and on an entry a NaN; an infinite dsig zeroes every cost
    expected[slot(1, 4 * _DSIGS.index(0.0) + 2)] = float(crw[0])
    expected[slot(1, 4 * _DSIGS.index(0.0))] = 0.0
    expected[slot(1, 4 * _DSIGS.index(np.inf))] = float(crw[0])
    # 2: band 0's infinite entries cost +inf and never win
    for i, k in enumerate((36, 38, 40, 42, 33, 45)):  # 33 and 45: the swapped speeds
        feats[slot(2, i)] = lut[0, k], 0.1, 0.0, 0.0
        expected[slot(2, i)] = float(crw[k])
    # 3: band 2's NaN entry poisons every pixel
    for q in range(bs):
        expected[slot(3, q)] = 0.0
    # 4: one live 32-pixel group; 5: a lone live pixel; 6: padding only
    pad(4, 32)
    pad(5, 0, 150)
    pad(5, 151)
    feats[slot(5, 150)] = lut[1, sets[1][1]], 0.3, 0.0, 0.0
    expected[slot(5, 150)] = float(crw[sets[1][0]])
    pad(6, 0)
    for b, live in ((4, range(32)), (5, [150]), (6, [])):
        for q in set(range(bs)) - set(live):
            expected[slot(b, q)] = 0.0
    # 7: NaN groups between live ones in both warps
    pad(7, 32, 64)
    pad(7, 128 + 64, 128 + 96)
    for q in [*range(32, 64), *range(128 + 64, 128 + 96)]:
        expected[slot(7, q)] = 0.0
    return CrosspolSeamCases(crlut=lut, crw=crw, feats=feats, band_of_block=band_of_block,
                             expected=expected)


def fused_crosspol_seam_cases(n_cr=771, n_phi=37, seed=0):
    """K2 on the slab sweep's seam blocks (:func:`seam_cases` at width
    ``n_phi``) with the crosspol seam row of width ``n_cr``. Returns
    ``(cases, expected)``, expected: slot -> the designed crosspol speed
    (K2's third output row). K2 derives the prior from its copol solution,
    so the designed ties sit on pixels without copol sigma0 (block 10,
    whose groups the sweep skips), next to pixels that skip the crosspol
    (NaN s0_cr) and pixels with every dsig of the list."""
    cases = seam_cases(n_phi=n_phi, n_cr=n_cr, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lut, crw, sets = _crosspol_table(n_cr, rng)
    cases.crlut, cases.crw = lut, crw
    bs = K.SLAB_BLOCK
    feats = cases.feats
    live = ~np.isnan(feats[:, 4])  # padding slots stay NaN
    n_live = int(live.sum())
    feats[live, 4] = rng.uniform(-40, -20, n_live).astype(np.float32)
    feats[live, 5] = rng.choice([0.1, 0.3, 1.0], n_live).astype(np.float32)
    expected = {}
    # block 10 (band 1, every s0 NaN): the tie sets from each of their entries
    p = 10 * bs
    for cells in sets:
        for k in cells:
            for dsig in (0.1, 1.0):
                feats[p, 4:6] = lut[1, k], dsig
                expected[p] = float(crw[cells[0]])
                p += 1
    # block 0 (band 0, copol solved): every dsig and s0 of the lists, and
    # pixels that skip the crosspol between pixels that run it
    p = 0
    for dsig in _DSIGS:
        for s0 in (lut[0, 60], np.float32(-30.013)):
            feats[p, 4:6] = s0, dsig
            p += 1
    for s0 in _S0S:
        feats[p, 4:6] = s0, 0.1
        p += 1
    feats[p:p + 40:2, 4] = np.nan
    for q in range(p, p + 40, 2):
        expected[q] = 0.0
    feats[p + 41, 5] = np.nan
    expected[p + 41] = 0.0
    # band 2's NaN entry poisons the crosspol of every pixel of its blocks
    for b in np.nonzero((cases.sband == 2) & (cases.vmask == 1))[0]:
        for q in range(b * bs, (b + 1) * bs):
            expected[q] = 0.0
    return cases, expected


# ------------------------------------------------------------------ quotient

def quotient_random_set(n, seed, device, windowed):
    """``(a, b)``, n float32 pairs drawn on ``device``: every bit pattern
    equally likely, or with ``windowed`` random signs and significands under
    exponents inside the hoisted quotient's windows (|b| in [2**-20, 2**20),
    |a| in [2**-34, 2**61))."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=device, dtype=torch.int64)

    def floats(bits):
        return bits.to(torch.int32).view(torch.float32)

    if not windowed:
        return floats(draw(-2 ** 31, 2 ** 31)), floats(draw(-2 ** 31, 2 ** 31))

    def inside(exp_lo, exp_hi):
        bits = draw(0, 2) << 31 | draw(exp_lo + 127, exp_hi + 127) << 23 | draw(0, 2 ** 23)
        return floats(bits - (bits >> 31 << 32))  # as a signed 32-bit pattern

    return inside(-34, 61), inside(-20, 20)


def quotient_edge_set(device, luts=()):
    """``(a, b)``: every pair of a list of edge values (zeros, denormals, the
    least and greatest normal numbers, infinities, NaN, significands of all
    zeros and all ones from 2**-40 to 2**70, both sides of the windows'
    edges, values whose quotients overflow and underflow), then, for each
    crosspol LUT of ``luts`` (2-D, dB), every entry minus its neighbour and
    minus an entry far away, over dsig 0.1, 0.3 and 1.0."""
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    values = [0.0, tiny, tiny * f32(2.0 ** -23), tiny * f32(1 - 2.0 ** -23), np.finfo(f32).max,
              3e38, np.inf, 0.1, 0.3, 1.0, 3.0, 1e-30, 1e30]
    for e in [*range(-40, -14), *range(-12, 13, 3), *range(15, 71, 5), 20, 21, 61, 62]:
        p = f32(2.0) ** f32(e)
        values += [p, np.nextafter(p, f32(0)), np.nextafter(p, f32(np.inf)),
                   p * f32(2 - 2.0 ** -23), p * f32(1.5)]
    values = np.array(values, f32)
    values = np.concatenate([values, -values, [f32(np.nan)]])
    a = [np.repeat(values, values.shape[0])]
    b = [np.tile(values, values.shape[0])]
    for lut in luts:
        flat = np.asarray(lut, f32).reshape(-1)
        for shift in (1, 977):
            d = flat - np.roll(flat, shift)
            for dsig in (0.1, 0.3, 1.0):
                a.append(d)
                b.append(np.full(d.shape, dsig, f32))
    return (torch.as_tensor(np.concatenate(a), device=device),
            torch.as_tensor(np.concatenate(b), device=device))
