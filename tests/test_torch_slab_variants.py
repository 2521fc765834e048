"""The slab sweep's chunk height (``chunk_rows`` of K2 and K3), on the CPU:
the plain version of K3 at each height against the JAX package's
``slab_refine_pallas(..., rows_per_iter=r)`` run in interpret mode, bit for
bit on the blocks the TPU kernel runs, on the sweep's seam cases
(``ops/slab_seams.py``); the heights the wrappers refuse; the shared memory
a height takes; and the port of ``scripts/bench_slab_variants.py``
(``xsarsea_tpu_torch.scripts.bench_slab_variants``) end to end on small
tables. tests/test_torch_cuda.py holds the kernels at every height against
these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.slab_seams import seam_cases
from xsarsea_tpu_torch.scripts import bench_slab_variants

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def cases():
    return seam_cases(n_phi=37)


# every rows_per_iter of the JAX script (scripts/bench_slab_variants.py:129)
# that divides the 48-row slab
@pytest.mark.parametrize("rows", [r for r in (8, 16, 24, 48) if K.SLAB_ROWS % r == 0])
def test_k3_plain_at_each_chunk_height_bit_equal_to_pallas_rows_per_iter(cases, rows):
    ref = np.asarray(jpi.slab_refine_pallas(
        *(jnp.asarray(a) for a in jpi.build_direct_arrays(cases.lut, cases.u, cases.v)),
        jnp.asarray(cases.feats[:, :4]), jnp.asarray(cases.sband), jnp.asarray(cases.srow0),
        cases.n_phi, n_rows=K.SLAB_ROWS, interpret=True, valid_mask=jnp.asarray(cases.vmask),
        rows_per_iter=rows))
    got = K.slab_refine(*cases.k3_args("cpu"), chunk_rows=rows, index=cases.index("cpu")).numpy()
    got = got.reshape(-1, K.SLAB_BLOCK)  # the reference's blocks
    live = cases.vmask == 1  # the TPU kernel leaves skipped blocks unwritten
    np.testing.assert_array_equal(got[live], ref[live])
    assert all(got.reshape(-1)[s] == e for s, e in cases.expected.items())


@pytest.mark.parametrize("chunk_rows", [0, 4, 12, 32, 64, "8", 8.5])
def test_chunk_rows_outside_the_heights_raise(cases, chunk_rows):
    with pytest.raises(ValueError, match="chunk_rows"):
        K.slab_refine(*cases.k3_args("cpu"), chunk_rows=chunk_rows, index=cases.index("cpu"))
    with pytest.raises(ValueError, match="chunk_rows"):
        K.slab_refine_fused(*cases.k2_args("cpu"), chunk_rows=chunk_rows,
                            index=cases.index("cpu"))


def test_every_height_gives_k2_the_same_bits(cases):
    index = cases.index("cpu")
    base = K.slab_refine_fused(*cases.k2_args("cpu"), index=index)
    for rows in K.CHUNK_ROWS:
        assert torch.equal(K.slab_refine_fused(*cases.k2_args("cpu"), chunk_rows=rows,
                                               index=index), base)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)  # plain versions count nothing


def test_slab_smem_bytes():
    """Two stages of l, u, v (and kr) at the chunk height, rows padded to 184
    floats at the production LUT's 181 phi; one stage for a one-chunk slab."""
    stride = 184
    assert K.slab_smem_bytes(181, 48) == 2 * 3 * 8 * stride * 4 == 35328
    assert K.slab_smem_bytes(181, 48, 16) == 2 * 3 * 16 * stride * 4
    assert K.slab_smem_bytes(181, 48, 24) == 2 * 3 * 24 * stride * 4
    assert K.slab_smem_bytes(181, 48, 48) == 3 * 48 * stride * 4  # one chunk: one stage
    assert K.slab_smem_bytes(181, 32, 48) == 3 * 48 * stride * 4
    assert K.slab_smem_bytes(181, 48, planes=4) == 2 * 4 * 8 * stride * 4 == 47104
    assert K.slab_smem_bytes(5, 8) == 2 * 4 * 128 * 4  # the partial minima, at least
    # what sm_90 lets a block opt in to bounds the width at each height
    assert K.slab_smem_bytes(181, 48, 48) <= 227 * 1024 < K.slab_smem_bytes(420, 48, 48)


def test_bench_slab_variants_main_on_cpu(capsys):
    res = bench_slab_variants.main(n=2 ** 12, device="cpu", inc_step=1.0, wspd_step=0.5,
                                   phi_step=5.0)
    out = capsys.readouterr().out
    assert "slab_refine chunk_rows=48" in out and "slab_refine_fused chunk_rows=16" in out
    assert set(res["kernels"]) == {"slab_refine", "slab_refine_fused"}
    assert res["refused"] == {"slab_refine": {}, "slab_refine_fused": {}}
    k3_args, k2_args = res["args"]["slab_refine"], res["args"]["slab_refine_fused"]
    slots = res["slots"]
    assert slots % K.SLAB_BLOCK == 0 and k3_args[3].shape == (slots, 4)
    assert k2_args[7].shape == (slots, 8)
    for name, runs in res["kernels"].items():
        assert set(runs) == set(K.CHUNK_ROWS)
        assert all(r["equal"] and r["ms"] is None for r in runs.values())
    # K2's winners are K3's, decoded
    k3 = res["kernels"]["slab_refine"][8]["out"].reshape(-1)
    k2 = res["kernels"]["slab_refine_fused"][8]["out"].T
    n_phi = k2_args[0].shape[2]
    valid = ~torch.isnan(k3_args[3][:, 0])  # not a padding slot
    hit = valid & (k3 < K._no_hit_flat(n_phi))
    assert hit.sum() > 0.9 * 2 ** 12
    assert torch.equal(k2[hit, 0], k2_args[3][(k3[hit] // n_phi).long()])
    # the crosspol columns are the scene's, padding slots NaN
    assert int(valid.sum()) == 2 ** 12
    assert torch.isnan(k2_args[7][~valid]).all() and (k2_args[7][valid, 5] == np.float32(0.1)).all()
