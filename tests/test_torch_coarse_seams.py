"""The seam cases of K1's coarse sweep and of the crosspol argmin
(``xsarsea_tpu_torch/ops/coarse_seams.py``) on the CPU: the plain versions
of K1, K4 and K2 against the answers the cases were built to have, K1
against the per-pixel loop, K4 and K2 against the JAX Pallas kernels in
interpret mode, bit for bit. tests/test_torch_cuda.py and ``chip_smoke.py``
hold the CUDA kernels against these plain versions on the same cases.
The CPU cases hold no denormal ``dsig_cr`` divisor, because XLA's CPU backend
flushes denormals and the JAX kernel in interpret mode then divides otherwise
than IEEE; the card test adds them and holds them against the plain version
only, not against JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu_torch.ops import experiment_kernels as E, inversion_kernels as K
from xsarsea_tpu_torch.ops.coarse_seams import (K1_CHAINS, K1_SET_PIXELS, coarse_row_group,
                                                coarse_seam_cases, coarse_tie_sets,
                                                crosspol_seam_cases, crosspol_tie_sets,
                                                fused_crosspol_seam_cases)

from test_torch_kernels import _group_argmin_loop

torch.set_num_threads(min(2, torch.get_num_threads()))

# coarse phi columns: a stride padded by one and by two NaN columns (the
# production grid's 46), and none
COARSE_WIDTHS = [19, 46, 48]
# crosspol entries: the sarwing LUT's and the high-res GMF's (a scalar tail
# of three) and a width without a tail
CROSSPOL_WIDTHS = [155, 160, 771]


def _wrong(got, expected):
    return {s: (got[s], e) for s, e in expected.items() if got[s] != e}


@pytest.mark.parametrize("n_cols", COARSE_WIDTHS)
def test_plain_k1_gives_the_designed_answers(n_cols):
    cases = coarse_seam_cases(n_cols)
    got = K.group_argmin(*cases.args("cpu"), index=cases.index("cpu")).numpy().reshape(-1)
    assert not _wrong(got, cases.expected)
    assert len(cases.expected) > 1400  # ties, sentinels and padding of every block kind
    assert len(set(cases.expected.values())) >= 12  # not one answer


@pytest.mark.parametrize("n_cols", COARSE_WIDTHS)
def test_plain_k1_equals_the_pixel_loop_on_seams(n_cols):
    cases = coarse_seam_cases(n_cols)
    got = K.group_argmin(*cases.args("cpu"), index=cases.index("cpu")).numpy().reshape(-1)
    with np.errstate(invalid="ignore", over="ignore"):
        ref = _group_argmin_loop(cases.lut_c, cases.u_half, cases.v_half, cases.row_group,
                                 cases.feats, cases.band_of_block, cases.n_groups,
                                 K.GROUP_BLOCK)
    np.testing.assert_array_equal(got, ref)


def test_plain_k1_takes_any_block_and_row_group_order():
    """The plain version keeps every block size and an unsorted row_group
    (a group's minimum over all of its rows); only the kernel narrows them."""
    cases = coarse_seam_cases(19)
    order = np.random.default_rng(3).permutation(cases.row_group.shape[0])
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in
            (cases.lut_c[:, order], cases.u_half[order], cases.v_half[order],
             cases.row_group[order], cases.feats, np.repeat(cases.band_of_block, 8))]
    got = K.group_argmin(*args, cases.n_groups, block=32,
                         index=cases.index("cpu")).numpy().reshape(-1)
    assert not _wrong(got, cases.expected)


@pytest.mark.parametrize("n_cols", COARSE_WIDTHS)
def test_coarse_tie_sets_straddle_every_split(n_cols):
    """Each split of K1 has a tie across it: groups in two chains (with the
    lower group in the higher chain), in one chain, rows of one group;
    columns in each float4 position and in the last real column; both pixel
    sets."""
    row_group = coarse_row_group()
    assert (np.diff(row_group) >= 0).all() and row_group[-1] == 31
    counts = np.bincount(row_group)
    assert {1, 2, 3} <= set(counts) and counts[-1] == 1
    sets = coarse_tie_sets(n_cols)
    pairs = [(a, b) for cells in sets for a in cells for b in cells if a < b]
    chain = lambda cell: cell[0] % K1_CHAINS  # noqa: E731
    assert any(chain(a) != chain(b) for a, b in pairs)
    assert any(a[0] < b[0] and chain(a) > chain(b) for a, b in pairs)
    assert any(a[0] != b[0] and chain(a) == chain(b) for a, b in pairs)
    assert any(a[0] == b[0] and a[1] != b[1] for a, b in pairs)
    cells = [c for s in sets for c in s]
    assert len(set(cells)) == len(cells)  # disjoint sets
    assert all(0 <= g < 32 and i < counts[g] and 0 <= c < n_cols for g, i, c in cells)
    assert {c % 4 for _, _, c in cells} == {0, 1, 2, 3} and n_cols - 1 in {c for _, _, c in cells}
    slots = np.array(sorted(coarse_seam_cases(n_cols).expected))
    in_block = slots % K.GROUP_BLOCK
    assert set(in_block // K1_SET_PIXELS) == {0, 1}
    assert set(in_block % K1_SET_PIXELS // 32) == {0, 1, 2, 3}


@pytest.mark.parametrize("n_cr", CROSSPOL_WIDTHS)
def test_plain_k4_gives_the_designed_answers(n_cr):
    cases = crosspol_seam_cases(n_cr)
    got = K.crosspol_argmin(*cases.args("cpu"), index=cases.index("cpu")).numpy()
    assert not _wrong(got, cases.expected)
    assert len(cases.expected) > 1000 and len(set(cases.expected.values())) >= 12


@pytest.mark.parametrize("n_cr", CROSSPOL_WIDTHS)
def test_plain_k4_bit_equal_to_pallas_on_seams(n_cr):
    cases = crosspol_seam_cases(n_cr)
    ref = np.asarray(jpi.crosspol_argmin_pallas(
        *(jnp.asarray(a) for a in jpi.build_crosspol_arrays(cases.crlut, cases.crw)),
        jnp.asarray(cases.feats), jnp.asarray(cases.band_of_block), block=K.CR_BLOCK,
        interpret=True))
    got = K.crosspol_argmin(*cases.args("cpu"), index=cases.index("cpu")).numpy()
    # tolerance 0: the same f32 op sequence with a true divide, the same
    # first-minimum rule and the same NaN poisoning
    np.testing.assert_array_equal(got, ref.reshape(-1))


@pytest.mark.parametrize("n_cr", CROSSPOL_WIDTHS)
def test_plain_k2_gives_the_designed_crosspol_answers(n_cr):
    cases, expected = fused_crosspol_seam_cases(n_cr)
    got = K.slab_refine_fused(*cases.k2_args("cpu"), index=cases.index("cpu")).numpy().T
    assert not _wrong(got[:, 2], expected)
    assert len(expected) > 400 and len(set(expected.values())) >= 6
    # pixels that skip the crosspol (NaN s0_cr) sit between pixels that run it
    skip = np.isnan(cases.feats[:K.SLAB_BLOCK, 4])
    assert skip.any() and (got[:K.SLAB_BLOCK, 2][~skip] > 0).any()
    assert (got[:K.SLAB_BLOCK, 2][skip] == 0).all()


@pytest.mark.parametrize("n_cr", CROSSPOL_WIDTHS)
def test_plain_k2_bit_equal_to_pallas_on_crosspol_seams(n_cr):
    cases, _ = fused_crosspol_seam_cases(n_cr)
    jax_direct = jpi.build_direct_arrays(cases.lut, cases.u, cases.v)
    wp, pp = jax_direct[0].shape[1:]
    ops = (*jax_direct, *jpi.build_decode_arrays(cases.wspd, cases.phir, wp, pp),
           *jpi.build_crosspol_arrays(cases.crlut, cases.crw))
    ref = np.asarray(jpi.slab_refine_fused_pallas(
        *(jnp.asarray(a) for a in ops), jnp.asarray(cases.feats), jnp.asarray(cases.sband),
        jnp.asarray(cases.srow0), cases.n_phi, n_rows=K.SLAB_ROWS, has_cr=True, interpret=True,
        valid_mask=jnp.asarray(cases.vmask)))
    got = K.slab_refine_fused(*cases.k2_args("cpu"), index=cases.index("cpu")).numpy()
    got = got.reshape(3, -1, K.SLAB_BLOCK).transpose(1, 0, 2)  # the reference's rows per block
    live = cases.vmask == 1  # the TPU kernel leaves skipped blocks unwritten
    np.testing.assert_array_equal(got[live], ref[live][:, :3])  # tolerance 0, as for K4


@pytest.mark.parametrize("n_cr", CROSSPOL_WIDTHS)
def test_crosspol_tie_sets_straddle_every_split(n_cr):
    """The crosspol loop's splits each have a tie across them: one float4,
    across float4s, the last float4 and the scalar tail where the width has
    one, the first and the last entry."""
    sets = crosspol_tie_sets(n_cr)
    pairs = [(a, b) for cells in sets for a in cells for b in cells if a < b]
    tail = n_cr - n_cr % 4
    assert any(a // 4 == b // 4 for a, b in pairs)
    assert any(a // 4 != b // 4 and b < tail for a, b in pairs)
    assert n_cr == tail or any(a < tail <= b for a, b in pairs)
    assert n_cr == tail or any(tail <= a for a, b in pairs)
    cells = [k for s in sets for k in s]
    assert len(set(cells)) == len(cells) and 0 in cells and n_cr - 1 in cells
    assert any(len(s) == 4 and s[0] % 4 == 0 for s in sets)  # a whole float4
    crw = crosspol_seam_cases(n_cr).crw
    assert (np.diff(crw) < 0).any()  # the wind-speed row does not ascend


def test_crosspol_quotient_is_the_true_divide_on_the_cpu():
    a = torch.tensor([1.0, -3.0, 0.0, float("inf")])
    b = torch.tensor([3.0, 0.3, 0.0, 2.0])
    q, hoisted = E.crosspol_quotient(a, b)
    assert torch.equal(q.nan_to_num(7.0), (a / b).nan_to_num(7.0)) and not hoisted.any()
    with pytest.raises(ValueError, match="shapes"):
        E.crosspol_quotient(a, b[:2])
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
