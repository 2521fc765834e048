"""K6, the coarse pass's expanded-form variants (plain PyTorch versions of
both engines, on the CPU), against a jnp transcription of the TPU kernel's
body (``scripts/bench_kernel_variants.py:32-57``); the tensor-core engine's
operands (the three-term bf16 split against the JAX package's
``_split3_bf16``, and g4's A-fragment layout); its near-tie gate; and the
script ``xsarsea_tpu_torch.scripts.bench_kernel_variants`` on a few
blocks.

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

from xsarsea_tpu.ops.pallas_inversion import _split3_bf16
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


@pytest.mark.parametrize("block", E.VARIANT_BLOCKS)
@pytest.mark.parametrize("reduction", E.REDUCTIONS)
@pytest.mark.parametrize("precision", E.PRECISIONS)
def test_tensor_core_plain_matches_tpu_body_except_near_ties(block, reduction, precision):
    """The tensor-core engine's plain version (the same bf16 rounding, or
    the nine cross products of the three-term splits summed in f32) against
    the TPU body with its product summed left to right: equal but at
    near-ties; at ``default`` it is that body, bit for bit."""
    g4, feats, bob = _operands(block)
    got = E.group_argmin_variant(*(torch.as_tensor(a) for a in (g4, feats, bob)), block=block,
                                 reduction=reduction, precision=precision,
                                 engine="tensor_cores").numpy()
    assert got.shape == (N_BLOCKS, 1, block) and got.dtype == np.int32
    ref = _tpu_body(g4, feats, bob, reduction, precision, "explicit")
    if precision == "default":
        np.testing.assert_array_equal(got, ref)
    differ = got != ref
    excused = _near_tie(g4, feats, bob, reduction, precision)[:, None]
    assert not (differ & ~excused).any(), np.argwhere(differ & ~excused)[:5]
    assert got[NAN_PIXEL[0], 0, NAN_PIXEL[1]] == N_GROUPS - 1
    assert E.launch_counts() == {}


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_split3_bf16_reproduces_the_jax_split():
    """The port's split equals ``_split3_bf16`` bit for bit on random f32
    over the whole exponent range (where residuals fall below 2**-126 the
    JAX split flushes them, and so does the port's) and on +-0,
    subnormals, the largest floats (whose first term overflows to inf) and
    +-inf; NaN stays NaN (neither framework fixes a NaN's payload)."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=4096) * 2.0 ** rng.integers(-126, 127, 4096)).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.17e-38, 6e-39,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max, 3.3e38,
                        np.inf, -np.inf, np.nan, 1.0000001, -2.9999998,
                        -2.802092e-38, 1.8954689e-36, -2.1041376e-34], np.float32)
    x = np.concatenate([x, special])
    ref = [np.asarray(t.astype(jnp.float32)) for t in _split3_bf16(jnp.asarray(x))]
    got = [t.to(torch.float32).numpy() for t in E.split3_bf16(torch.as_tensor(x))]
    for r, g in zip(ref, got):
        nan = np.isnan(r)
        np.testing.assert_array_equal(np.isnan(g), nan)
        np.testing.assert_array_equal(_bits(g)[~nan], _bits(r)[~nan])
    # exact wherever the terms are finite and the residuals normal
    normal = np.isfinite(ref[2]) & (np.abs(x) >= 2.0 ** -102)
    with np.errstate(invalid="ignore"):  # inf - inf in the sums of non-finite terms
        total = sum(t.astype(np.float64) for t in got)
    np.testing.assert_array_equal(total[normal], x[normal].astype(np.float64))


@pytest.mark.parametrize("precision", E.PRECISIONS)
def test_split_g4_is_the_a_fragments_of_the_product(precision):
    """g4's tensor-core operand decoded by mma.sync's A-fragment layout (lane
    4g + t, word w: rows g + 8 (w & 1), columns 2t + 8 (w >> 1) + {0, 1})
    gives each entry's row: its channels' split terms (``highest``) or
    bf16 roundings (``default``), then zeros."""
    rng = np.random.default_rng(12)
    g4 = torch.as_tensor(rng.normal(size=(2, 4, 4, 2048)).astype(np.float32))
    words = E.split_g4(g4, precision).numpy().view(np.uint32)
    n_k = 16 if precision == "highest" else 8
    assert words.shape == (2, 4, 128, 32, n_k // 4)
    a = np.zeros((2, 4, 128, 16, n_k), np.float32)  # (band, tile, M-tile, row, k)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for w in range(words.shape[-1]):
            for h in range(2):
                half = ((words[..., lane, w] >> (16 * h)) & 0xFFFF).astype(np.uint32) << 16
                a[:, :, :, g + 8 * (w & 1), 2 * t + 8 * (w >> 1) + h] = half.view(np.float32)
    a = a.reshape(2, 4, 2048, n_k)  # entry e = 16 M-tile + row
    if precision == "highest":
        terms = [t.to(torch.float32).numpy() for t in E.split3_bf16(g4)]
        want = np.concatenate([np.moveaxis(t, 2, 3) for t in terms], -1)  # k = 4 s + c
    else:
        want = np.moveaxis(E._bf16(g4).numpy(), 2, 3)
    np.testing.assert_array_equal(a[..., :want.shape[-1]], want)
    assert (a[..., want.shape[-1]:] == 0).all()
    assert E.launch_counts() == {}


def test_tc_flips_excuses_only_near_ties():
    """Rows 3 and 5 of every band are one group's entries twice: a pixel
    moved from one to the other is a near-tie (|dJ| = 0), one moved to its
    largest row is not."""
    g4, feats, bob = _operands(256, seed=3)
    g4[:, 0, :, 5 * GSIZE:6 * GSIZE] = g4[:, 0, :, 3 * GSIZE:4 * GSIZE]
    args = [torch.as_tensor(a) for a in (g4, feats, bob)]
    kw = dict(block=256, reduction="reshape", precision="highest")
    ref = E.group_argmin_variant(*args, **kw, engine="tensor_cores")
    got = ref.clone()
    tied = torch.nonzero(ref.reshape(-1) == 3)[:, 0][:2]
    assert tied.numel() == 2
    got.view(-1)[tied] = 5
    far = 7  # a pixel away from the tie: its largest group row
    f = feats[0, :, far].astype(np.float64)
    rows = np.einsum("tke,k->te", g4[bob[0]].astype(np.float64), f)
    rows = rows.reshape(N_TILES, GPT, GSIZE).min(-1).reshape(-1)
    got.view(-1)[far] = int(np.argmax(rows))
    report = E.tc_flips(*args, got, ref, **kw)
    assert report["differ"] == 3 and report["near_tie"] == 2 and report["not_near_tie"] == 1
    assert report["worst"] > E.TIE_REL
    assert E.tc_flips(*args, ref, ref, **kw) == {"differ": 0, "near_tie": 0, "not_near_tie": 0,
                                                 "worst": 0.0}


def test_engine_and_split_refuse_bad_calls():
    g4, feats, bob = (torch.zeros((1, 4, 4, 2048)), torch.zeros((1, 4, 256)),
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown engine"):
        E.group_argmin_variant(g4, feats, bob, block=256, reduction="reshape",
                               precision="highest", engine="wgmma")
    with pytest.raises(ValueError, match="unknown precision"):
        E.split_g4(g4, "tf32")
    with pytest.raises(ValueError, match="device"):
        E.split_g4(g4.to("meta"), "highest")
    with pytest.raises(ValueError, match="device"):
        E.group_argmin_variant(g4, feats.to("meta"), bob, block=256, reduction="reshape",
                               precision="highest", engine="tensor_cores")


def test_bench_kernel_variants_runs_both_engines_on_cpu(capsys):
    res = bench_kernel_variants.run(n=2 ** 11, device="cpu")
    out = capsys.readouterr().out
    assert "split_g4 precision=highest" in out and "tensor_cores" in out
    assert set(res["g4_split"]) == set(E.PRECISIONS)
    assert res["split_ms"] == {p: None for p in E.PRECISIONS}
    g4 = res["variants"][0]["args"][0]
    for p, split in res["g4_split"].items():
        assert torch.equal(split, E.split_g4(g4, p))
    for r in res["variants"]:
        tc = r["tensor_cores"]
        assert tc["ms"] is None and tc["out"].shape == r["out"].shape
        assert r["differ"] == int((tc["out"] != r["out"]).sum())
        kw = r["kwargs"]
        flips = E.tc_flips(*r["args"], tc["out"], r["out"], **kw)
        assert flips["not_near_tie"] == 0, (kw, flips)
    assert E.launch_counts() == {}
