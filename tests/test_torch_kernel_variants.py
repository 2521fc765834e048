"""K6, the coarse pass's expanded-form variants (plain PyTorch version, on
the CPU), against a jnp transcription of the TPU kernel's body
(``scripts/bench_kernel_variants.py:32-57``), and its driver
``xsarsea_tpu_torch.scripts.bench_kernel_variants`` on a few blocks.

The JAX script cannot be imported: it runs its 2**23-pixel benchmarks at
import. The transcription runs eagerly, one XLA computation per jnp op, so
no multiply-add is contracted. ``default`` precision rounds both operands
to bf16 with ``astype``, since a CPU ``dot_general`` ignores
``Precision.DEFAULT``; the products of bf16 values are exact in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.scripts import bench_kernel_variants

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))

TILE, GSIZE, N_TILES = 2048, 256, 4  # the script's constants
GPT = TILE // GSIZE
N_GROUPS = 32
N_BANDS, N_BLOCKS = 5, 8
NAN_PIXEL = (2, 3)  # (block, pixel) with a NaN feature


def _operands(block, seed=0):
    rng = np.random.default_rng(seed)
    g4 = rng.normal(size=(N_BANDS, N_TILES, 4, TILE)).astype(np.float32)
    feats = rng.normal(size=(N_BLOCKS, 4, block)).astype(np.float32)
    feats[NAN_PIXEL[0], 1, NAN_PIXEL[1]] = np.nan
    bob = np.sort(rng.integers(0, N_BANDS, N_BLOCKS)).astype(np.int32)
    return g4, feats, bob


def _tpu_rows(g, f, reduction, product):
    """One block's 32 scratch rows (32, block), as the TPU kernel fills
    them tile by tile; ``flat_min``'s 7 unwritten rows per tile are +inf,
    as the port defines them."""
    rows = []
    for t in range(N_TILES):
        gt = g[t]  # (4, TILE)
        if product == "explicit":  # left to right, each product rounded
            j = gt[0][:, None] * f[0][None, :] + gt[1][:, None] * f[1][None, :]
            j = j + gt[2][:, None] * f[2][None, :]
            j = j + gt[3][:, None] * f[3][None, :]
        else:
            j = lax.dot_general(gt, f, (((0,), (0,)), ((), ())), precision=lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32)
        if reduction == "reshape":
            gm = jnp.min(j.reshape(GPT, GSIZE, j.shape[1]), axis=1)
        elif reduction == "static_slices":
            gm = jnp.stack([jnp.min(j[k * GSIZE:(k + 1) * GSIZE], axis=0) for k in range(GPT)])
        elif reduction == "flat_min":
            gm = jnp.concatenate([jnp.min(j, axis=0, keepdims=True),
                                  jnp.full((GPT - 1, j.shape[1]), jnp.inf, jnp.float32)])
        else:
            gm = j[:GPT]
        rows.append(gm)
    return jnp.concatenate(rows)


def _tpu_body(g4, feats, bob, reduction, precision, product):
    """The kernel body per block: the scratch rows, then the first row
    holding their NaN-propagating minimum, clipped to the last group."""
    out = np.empty((feats.shape[0], 1, feats.shape[2]), np.int32)
    for b in range(feats.shape[0]):
        g, f = jnp.asarray(g4[bob[b]]), jnp.asarray(feats[b])
        if precision == "default":
            g = g.astype(jnp.bfloat16).astype(jnp.float32)
            f = f.astype(jnp.bfloat16).astype(jnp.float32)
        scr = _tpu_rows(g, f, reduction, product)
        tmin = jnp.min(scr, axis=0, keepdims=True)
        gidx = lax.broadcasted_iota(jnp.int32, scr.shape, 0)
        best = jnp.min(jnp.where(scr == tmin, gidx, 2 ** 30), axis=0, keepdims=True)
        out[b] = np.asarray(jnp.clip(best, 0, N_GROUPS - 1))
    return out


def _near_tie(g4, feats, bob, reduction, precision):
    """Pixels whose two lowest scratch rows, in float64 from the same
    (rounded) operands, lie within 4 float32 ulps: a float32 product summed
    in another order may swap them."""
    g, f = g4[bob].astype(np.float64), feats.astype(np.float64)
    if precision == "default":
        g = np.asarray(jnp.asarray(g4[bob]).astype(jnp.bfloat16).astype(jnp.float64))
        f = np.asarray(jnp.asarray(feats).astype(jnp.bfloat16).astype(jnp.float64))
    j = np.einsum("btke,bkp->btep", g, f)  # (blocks, tiles, entries, block)
    if reduction in ("reshape", "static_slices"):
        rows = j.reshape(*j.shape[:2], GPT, GSIZE, -1).min(3)
    elif reduction == "flat_min":
        rows = np.full((*j.shape[:2], GPT, j.shape[-1]), np.inf)
        rows[:, :, 0] = j.min(2)
    else:
        rows = j[:, :, :GPT]
    two = np.sort(rows.reshape(j.shape[0], N_GROUPS, -1), axis=1)[:, :2]
    ulp = np.spacing(np.abs(two[:, 0]).astype(np.float32)).astype(np.float64)
    with np.errstate(invalid="ignore"):  # the NaN pixel's rows
        return np.abs(two[:, 1] - two[:, 0]) <= 4 * ulp


@pytest.mark.parametrize("block", E.VARIANT_BLOCKS)
@pytest.mark.parametrize("reduction", E.REDUCTIONS)
@pytest.mark.parametrize("precision", E.PRECISIONS)
def test_group_argmin_variant_plain_matches_tpu_body(block, reduction, precision):
    g4, feats, bob = _operands(block)
    got = E.group_argmin_variant(*(torch.as_tensor(a) for a in (g4, feats, bob)), block=block,
                                 reduction=reduction, precision=precision).numpy()
    assert got.shape == (N_BLOCKS, 1, block) and got.dtype == np.int32
    # bit-equal to the body with the product summed left to right
    np.testing.assert_array_equal(got, _tpu_body(g4, feats, bob, reduction, precision,
                                                 "explicit"))
    assert got[NAN_PIXEL[0], 0, NAN_PIXEL[1]] == N_GROUPS - 1  # a NaN row gives 31
    # against XLA's dot_general, which may sum the 4 products in another order:
    # equal except where the two best rows lie within 4 float32 ulps
    ref = _tpu_body(g4, feats, bob, reduction, precision, "dot_general")
    differ = got != ref
    excused = _near_tie(g4, feats, bob, reduction, precision)[:, None]
    assert not (differ & ~excused).any(), np.argwhere(differ & ~excused)[:5]
    assert excused.sum() <= 0.01 * got.size, int(excused.sum())
    assert E.launch_counts() == {}


def test_flat_min_and_none_read_what_they_keep():
    """flat_min keeps one row per tile (rows 0, 8, 16, 24); none keeps the
    first 8 entries of a tile, so an entry past them never changes it."""
    g4, feats, bob = _operands(256, seed=1)
    args = [torch.as_tensor(a) for a in (g4, feats, bob)]
    flat = E.group_argmin_variant(*args, block=256, reduction="flat_min", precision="highest")
    ok = np.ones(flat.shape, bool)
    ok[NAN_PIXEL[0], 0, NAN_PIXEL[1]] = False
    assert set(np.unique(flat.numpy()[ok])) <= {0, 8, 16, 24}
    none = E.group_argmin_variant(*args, block=256, reduction="none", precision="highest")
    g4[:, :, :, GPT:] = -1e30
    again = E.group_argmin_variant(torch.as_tensor(g4), *args[1:], block=256, reduction="none",
                                   precision="highest")
    assert torch.equal(none, again)


def test_group_argmin_variant_refuses_bad_calls():
    g4, feats, bob = (torch.zeros((1, 4, 4, 2048)), torch.zeros((1, 4, 256)),
                      torch.zeros(1, dtype=torch.int32))
    for kw in (dict(block=128, reduction="reshape", precision="highest"),
               dict(block=256, reduction="min", precision="highest"),
               dict(block=256, reduction="reshape", precision="tf32")):
        with pytest.raises(ValueError, match="unknown variant"):
            E.group_argmin_variant(g4, feats, bob, **kw)
    with pytest.raises(ValueError, match="device"):
        E.group_argmin_variant(g4, feats.to("meta"), bob, block=256, reduction="reshape",
                               precision="highest")


def test_bench_kernel_variants_main_on_cpu(capsys):
    res = bench_kernel_variants.main(n=2 ** 11, device="cpu")
    out = capsys.readouterr().out
    assert [r["label"] for r in res] == [v[0] for v in bench_kernel_variants.VARIANTS]
    assert "one function with reshape on this card" in out
    for r, (_, block, reduction, precision) in zip(res, bench_kernel_variants.VARIANTS):
        assert r["ms"] is None and r["out"].shape == (2 ** 11 // block, 1, block)
        assert r["kwargs"] == dict(block=block, reduction=reduction, precision=precision)
        assert int(r["out"].min()) >= 0 and int(r["out"].max()) < N_GROUPS
    # the JAX script's draws: g4 first, then feats and sorted bands per variant
    rng = np.random.default_rng(0)
    g4 = bench_kernel_variants.make_g4(rng)
    assert np.array_equal(res[0]["args"][0].numpy(), g4)
    feats, bob = bench_kernel_variants.make_inputs(rng, 256, 2 ** 11)
    assert np.array_equal(res[0]["args"][1].numpy(), feats)
    assert np.array_equal(res[0]["args"][2].numpy(), bob) and (np.diff(bob) >= 0).all()
    assert E.launch_counts() == {}
