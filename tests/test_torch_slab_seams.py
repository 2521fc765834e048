"""The seam cases of the K2/K3 slab sweep (``xsarsea_tpu_torch/ops/slab_seams.py``)
on the CPU: the plain versions of K2 and K3 against the JAX Pallas kernels
in interpret mode, bit for bit, and against the answers the cases were
built to have. tests/test_torch_cuda.py and ``chip_smoke.py`` hold the CUDA
kernels against these plain versions on the same cases.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.slab_seams import seam_cases, tie_sets

torch.set_num_threads(min(2, torch.get_num_threads()))

# phi columns: a scalar tail of one column after the float4s, none, and the
# production LUT's
WIDTHS = [37, 72, 181]


@pytest.fixture(scope="module", params=WIDTHS)
def cases(request):
    return seam_cases(n_phi=request.param)


def test_plain_k3_gives_the_designed_answers(cases):
    got = K.slab_refine(*cases.k3_args("cpu"), index=cases.index("cpu")).numpy().reshape(-1)
    wrong = {s: (int(got[s]), e) for s, e in cases.expected.items() if got[s] != e}
    assert not wrong
    assert (got.reshape(-1, K.SLAB_BLOCK)[cases.vmask == 0] == 0).all()
    assert len(cases.expected) > 700  # ties, sentinels and padding of every block kind


def test_plain_k3_bit_equal_to_pallas_on_seams(cases):
    ref = np.asarray(jpi.slab_refine_pallas(
        *(jnp.asarray(a) for a in jpi.build_direct_arrays(cases.lut, cases.u, cases.v)),
        jnp.asarray(cases.feats[:, :4]), jnp.asarray(cases.sband), jnp.asarray(cases.srow0),
        cases.n_phi, n_rows=K.SLAB_ROWS, interpret=True, valid_mask=jnp.asarray(cases.vmask)))
    got = K.slab_refine(*cases.k3_args("cpu"), index=cases.index("cpu")).numpy()
    got = got.reshape(-1, K.SLAB_BLOCK)  # the reference's blocks
    live = cases.vmask == 1  # the TPU kernel leaves skipped blocks unwritten
    np.testing.assert_array_equal(got[live], ref[live])


def test_plain_k2_bit_equal_to_pallas_on_seams(cases):
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
    live = cases.vmask == 1
    np.testing.assert_array_equal(got[live], ref[live][:, :3])


def test_plain_k2_decodes_k3s_winners_and_solves_crosspol_without_copol(cases):
    k2 = K.slab_refine_fused(*cases.k2_args("cpu"), index=cases.index("cpu")).numpy().T
    k3 = K.slab_refine(*cases.k3_args("cpu"), index=cases.index("cpu")).numpy().reshape(-1)
    n_phi = cases.n_phi
    w_pad = cases.k2_args("cpu")[3].numpy()  # 0 on padding rows
    for s, idx in cases.expected.items():
        if idx < K._no_hit_flat(n_phi):  # a winner: K2 decodes the same cell
            assert k2[s, 0] == w_pad[idx // n_phi] and k2[s, 1] == cases.phir[idx % n_phi]
        elif idx == K._NAN_IDX:  # poisoned
            assert (k2[s, :2] == 0).all()
    for s in cases.crosspol_slots:  # NaN s0, in a group the sweep skips
        assert np.isnan(cases.feats[s, 0]) and k3[s] == K._NAN_IDX
        assert k2[s, 0] == 0 and k2[s, 2] > 0


@pytest.mark.parametrize("n_phi", WIDTHS)
def test_tie_sets_straddle_every_split(n_phi):
    """Each split of the sweep has a tie across it: rows in two warps (r mod
    4), in two chunks (r // 8), in one warp; columns in one float4, across
    float4s, and in the scalar tail where the width has one."""
    sets = tie_sets(n_phi)
    pairs = [(a, b) for cells in sets for a in cells for b in cells if a < b]
    tail = n_phi - n_phi % 4
    assert any(a[0] % 4 != b[0] % 4 and a[0] // 8 == b[0] // 8 for a, b in pairs)
    assert any(a[0] // 8 != b[0] // 8 for a, b in pairs)
    assert any(a[0] % 4 == b[0] % 4 and a[0] != b[0] for a, b in pairs)
    assert any(a[0] == b[0] and a[1] // 4 == b[1] // 4 for a, b in pairs)
    assert any(a[0] == b[0] and a[1] // 4 != b[1] // 4 and max(a[1], b[1]) < tail
               for a, b in pairs)
    assert n_phi == tail or any(max(a[1], b[1]) >= tail for a, b in pairs)
    cells = [c for s in sets for c in s]
    assert len(set(cells)) == len(cells)  # disjoint sets
    assert all(0 <= r < K.SLAB_ROWS and 0 <= c < n_phi for r, c in cells)
