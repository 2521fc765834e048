"""The fused inversion's kernels (plain PyTorch versions, on the CPU)
against the JAX package's Pallas kernels run in interpret mode, and the
coarse pass's contract with the exact path. K2, K3 and K4 are held bit for
bit, NaN sentinels and first-minimum ties included.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there. The operands here are in
slot order already: the kernels read them through the identity permutation,
so K2-K4's pixel-order results are in slot order too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.bucketing import _f32_sort_key_np, band_boundaries_f32, \
    bucket_by_value
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, _first_argmin, \
    _nearest_index

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))


def _identity(n):
    """The index of ``n`` rows already in slot order."""
    return torch.arange(n)


def _slab_case(seed, n_inc=5, n_wspd=90, n_phi=181, n_cr=60, nb=6):
    """Random direct-form operands in both packages' layouts, with a NaN LUT
    entry (poisons its band's pixels), padding rows, a NaN ancillary, a NaN
    copol sigma0 with valid crosspol, and a NaN crosspol sigma0."""
    rng = np.random.default_rng(seed)
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    lut[2, 30, 40] = np.nan
    wspd = np.linspace(0.2, 50, n_wspd).astype(np.float32)
    phir = np.deg2rad(np.linspace(0, 180, n_phi)).astype(np.float32)
    u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np.float32)
    crlut = rng.uniform(-40, -20, (n_inc, n_cr)).astype(np.float32)
    crw = np.linspace(3, 80, n_cr).astype(np.float32)

    jax_direct = jpi.build_direct_arrays(lut, u, v)
    port_direct = K.build_direct_arrays(lut, u, v)
    wp = port_direct[0].shape[1]
    assert jax_direct[0].shape[1] == wp
    n_groups = (n_wspd + K.WGROUP - 1) // K.WGROUP
    sband = rng.integers(0, n_inc, nb).astype(np.int32)
    sband[0] = 2
    srow0 = np.clip(rng.integers(0, n_groups, nb) * K.WGROUP - K.SLAB_MARGIN, 0,
                    wp - K.SLAB_ROWS).astype(np.int32)
    srow0[0] = 16  # band 2's NaN entry (row 30) inside the slab
    n = nb * K.SLAB_BLOCK
    feats = np.stack([rng.uniform(-30, -5, n), rng.uniform(-12, 12, n),
                      rng.uniform(0, 12, n), np.full(n, 10.0), rng.uniform(-38, -22, n),
                      rng.uniform(0.1, 1.0, n), np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    feats[3] = np.nan          # a padding slot
    feats[200, 1] = np.nan     # NaN ancillary: every cost NaN
    feats[201, 0] = np.nan     # no copol sigma0, crosspol still solved
    feats[202, 4] = np.nan     # no crosspol sigma0
    w_half, phi_row = jpi.build_decode_arrays(wspd, phir, wp, jax_direct[0].shape[2])
    jax_ops = (*jax_direct, w_half, phi_row, *jpi.build_crosspol_arrays(crlut, crw))
    port_ops = (*port_direct, K.build_decode_arrays(wspd, wp), phir,
                *K.build_crosspol_arrays(crlut, crw))
    return jax_ops, port_ops, feats, sband, srow0, n_phi


@pytest.mark.parametrize("seed", [0, 1])
def test_slab_refine_fused_plain_bit_equal_to_pallas(seed):
    jax_ops, port_ops, feats, sband, srow0, n_phi = _slab_case(seed)
    nb = sband.shape[0]
    ref = np.asarray(jpi.slab_refine_fused_pallas(
        *(jnp.asarray(a) for a in jax_ops), jnp.asarray(feats), jnp.asarray(sband),
        jnp.asarray(srow0), n_phi, n_rows=K.SLAB_ROWS, has_cr=True, interpret=True,
        valid_mask=jnp.ones(nb, jnp.int32)))
    got = K.slab_refine_fused(*(torch.as_tensor(a) for a in port_ops), torch.as_tensor(feats),
                              torch.as_tensor(sband), torch.as_tensor(srow0),
                              torch.ones(nb, dtype=torch.int32),
                              index=_identity(feats.shape[0])).numpy()
    # expected bit-equal: the same f32 op sequence, the same first-minimum
    # rule and the same NaN poisoning; the reference's rows per block
    np.testing.assert_array_equal(got, ref[:, :3].transpose(1, 0, 2).reshape(3, -1))
    poisoned = got[0, :K.SLAB_BLOCK] == 0  # band 2's NaN LUT entry inside block 0's slab
    assert poisoned.any() and (got[1, :K.SLAB_BLOCK][poisoned] == 0).all()
    flat = got.T
    assert (flat[200, :2] == 0).all() and flat[201, 2] > 0 and flat[202, 2] == 0


def test_slab_refine_fused_plain_copol_only_and_skipped_blocks():
    jax_ops, port_ops, feats, sband, srow0, n_phi = _slab_case(2)
    nb = sband.shape[0]
    dummy = (jnp.zeros((1, 1, 128), jnp.float32), jnp.zeros((1, 128), jnp.float32))
    ref = np.asarray(jpi.slab_refine_fused_pallas(
        *(jnp.asarray(a) for a in jax_ops[:5]), *dummy, jnp.asarray(feats[:, :8]),
        jnp.asarray(sband), jnp.asarray(srow0), n_phi, n_rows=K.SLAB_ROWS, has_cr=False,
        interpret=True, valid_mask=jnp.ones(nb, jnp.int32)))
    vmask = torch.ones(nb, dtype=torch.int32)
    vmask[4] = 0
    got = K.slab_refine_fused(*(torch.as_tensor(a) for a in port_ops[:5]),
                              torch.zeros((1, 1)), torch.zeros(1), torch.as_tensor(feats),
                              torch.as_tensor(sband), torch.as_tensor(srow0), vmask,
                              has_cr=False, index=_identity(feats.shape[0])).numpy()
    got = got.reshape(3, nb, K.SLAB_BLOCK).transpose(1, 0, 2)  # the reference's rows per block
    keep = np.arange(nb) != 4
    np.testing.assert_array_equal(got[keep, :2], ref[keep, :2])
    assert (got[:, 2:] == 0).all() and (got[4] == 0).all()
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def _tied_direct_case(seed, n_inc=4, n_wspd=70, n_phi=37, nb=7):
    """K3 operands with exact cost ties and every sentinel: duplicated phi
    columns 4/5 and wspd rows 19/20 (pixels placed exactly on them tie at
    cost 0), a NaN LUT entry inside block 0's slab, padding slots, a pixel
    with no finite cost (1/dsig = inf), slabs reaching into the padding rows
    and skipped all-padding blocks."""
    rng = np.random.default_rng(seed)
    wspd = np.linspace(0.2, 30, n_wspd).astype(np.float32)
    wspd[20] = wspd[19]
    phir = np.deg2rad(np.linspace(0, 180, n_phi)).astype(np.float32)
    phir[5] = phir[4]
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    lut[:, :, 5] = lut[:, :, 4]
    lut[:, 20, :] = lut[:, 19, :]
    lut[1, 30, 9] = np.nan
    u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np.float32)
    port = K.build_direct_arrays(lut, u, v)
    wp = port[0].shape[1]
    sband = rng.integers(0, n_inc, nb).astype(np.int32)
    # block 4's slab straddles the last true row, block 6's holds padding rows only
    srow0 = np.array([16, 0, 16, 0, 48, 16, wp - K.SLAB_ROWS], np.int32)[:nb]
    sband[0] = 1  # row 30 of band 1 holds the NaN
    n = nb * K.SLAB_BLOCK
    feats = np.stack([rng.uniform(-30, -5, n), rng.uniform(-12, 12, n), rng.uniform(0, 12, n),
                      np.full(n, 10.0)], 1).astype(np.float32)
    # block 2 (band sband[2], rows 16..63): pixels exactly on the tied cells
    b2 = 2 * K.SLAB_BLOCK
    for k, (r, c) in enumerate([(19, 4), (20, 5), (19, 5), (25, 4), (40, 5)]):
        feats[b2 + k, :3] = lut[sband[2], r, c], u[r, c] * 0.5, v[r, c] * 0.5
    feats[5] = np.nan              # a padding slot
    feats[b2 + 10, 3] = np.inf     # no finite cost
    feats[3 * K.SLAB_BLOCK:4 * K.SLAB_BLOCK] = np.nan  # an all-padding block
    vmask = np.ones(nb, np.int32)
    vmask[3] = 0
    return lut, u, v, port, feats, sband, srow0, vmask, n_phi


@pytest.mark.parametrize("seed", [0, 1])
def test_slab_refine_plain_bit_equal_to_pallas(seed):
    lut, u, v, port, feats, sband, srow0, vmask, n_phi = _tied_direct_case(seed)
    ref = np.asarray(jpi.slab_refine_pallas(
        *(jnp.asarray(a) for a in jpi.build_direct_arrays(lut, u, v)), jnp.asarray(feats),
        jnp.asarray(sband), jnp.asarray(srow0), n_phi, n_rows=K.SLAB_ROWS, interpret=True,
        valid_mask=jnp.asarray(vmask)))
    got = K.slab_refine(*(torch.as_tensor(a) for a in port), torch.as_tensor(feats),
                        torch.as_tensor(sband), torch.as_tensor(srow0), torch.as_tensor(vmask),
                        index=_identity(feats.shape[0])).numpy().reshape(-1, K.SLAB_BLOCK)
    # expected bit-equal on every block that runs: the same f32 op sequence,
    # the same first-minimum rule and the same sentinels
    live = vmask == 1
    np.testing.assert_array_equal(got[live], ref[live])
    assert got.dtype == np.int32 and (got[~live] == 0).all()
    no_hit = ((2 ** 30 // n_phi) & ~1) * n_phi
    assert (got[0] == 2 ** 30).any()  # the NaN LUT entry inside block 0's slab
    assert got[0, 5] == 2 ** 30 and got[2, 10] == no_hit
    # ties go to the lowest flat index: row 19 over 20, column 4 over 5
    np.testing.assert_array_equal(got[2, :5], [19 * n_phi + 4] * 3 + [25 * n_phi + 4,
                                                                   40 * n_phi + 4])
    assert got[4].max() < lut.shape[1] * n_phi  # padding rows never win
    assert (got[6] == no_hit).all()


def _crosspol_case(seed, n_inc=5, n_cr=155, nb=6):
    """K4 operands: a duplicated LUT entry (columns 10/11) that pixels hit
    exactly with no copol prior, NaN crosspol sigma0, NaN dsig, has_co = 0,
    padding slots."""
    rng = np.random.default_rng(seed)
    crlut = rng.uniform(-40, -20, (n_inc, n_cr)).astype(np.float32)
    crlut[:, 11] = crlut[:, 10]
    crw = np.linspace(3, 80, n_cr).astype(np.float32)
    band = rng.integers(0, n_inc, nb).astype(np.int32)
    n = nb * K.CR_BLOCK
    wco = rng.uniform(0, 40, n).astype(np.float32)
    has_co = (rng.random(n) < 0.8).astype(np.float32)
    feats = np.stack([rng.uniform(-38, -22, n), rng.uniform(0.1, 1.0, n),
                      np.where(has_co > 0, wco, 0) * 0.5, has_co], 1).astype(np.float32)
    for k in range(4):  # exact ties at cost 0 with no prior: the first index wins
        feats[k] = crlut[band[0], 10], 0.3, 0.0, 0.0
    feats[7, 0] = np.nan
    feats[8, 1] = np.nan
    feats[9, 2:] = 0.0
    feats[n - 20:] = np.nan  # padding slots
    return crlut, crw, feats, band


@pytest.mark.parametrize("seed", [0, 1])
def test_crosspol_argmin_plain_bit_equal_to_pallas(seed):
    crlut, crw, feats, band = _crosspol_case(seed)
    ref = np.asarray(jpi.crosspol_argmin_pallas(
        *(jnp.asarray(a) for a in jpi.build_crosspol_arrays(crlut, crw)), jnp.asarray(feats),
        jnp.asarray(band), block=K.CR_BLOCK, interpret=True))
    got = K.crosspol_argmin(*(torch.as_tensor(a) for a in K.build_crosspol_arrays(crlut, crw)),
                            torch.as_tensor(feats), torch.as_tensor(band),
                            index=_identity(feats.shape[0])).numpy()
    np.testing.assert_array_equal(got, ref.reshape(-1))
    flat = got
    assert (flat[:4] == crw[10]).all()  # first minimum of the tied pair
    assert flat[7] == 0 and flat[8] == 0 and flat[9] > 0 and (flat[-20:] == 0).all()
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)


def _group_argmin_loop(lut_c, u_c, v_c, row_group, feats, band_of_block, n_groups, block):
    """Per-pixel loop reference: per-group minimum of the direct-form f32
    cost (NaN entries skipped), lowest group among equal minima."""
    out = np.empty(feats.shape[0], np.int32)
    for p, f in enumerate(feats):
        l = lut_c[band_of_block[p // block]]
        j = ((l - f[0]) * f[3]) ** 2 + (u_c - f[1]) ** 2 + (v_c - f[2]) ** 2
        j = np.where(np.isnan(j), np.inf, j).min(axis=1)
        gmin = np.array([j[row_group == g].min(initial=np.inf) for g in range(n_groups)])
        out[p] = np.argmin(gmin) if np.isfinite(gmin.min()) else n_groups - 1
    return out


def test_group_argmin_plain_matches_loop():
    rng = np.random.default_rng(5)
    lut = rng.uniform(-30, 0, (4, 70, 37)).astype(np.float32)
    wspd = np.linspace(0.2, 35, 70)
    phir = np.deg2rad(np.linspace(0, 180, 37))
    u = (wspd[:, None] * np.cos(phir)).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)).astype(np.float32)
    lut_c, u_c, v_c, row_group, n_groups = K.build_coarse_arrays(lut, u, v, 3, 2)
    assert n_groups == 5 and row_group[-1] == 69 // 16 and lut_c.shape == (4, 24, 19)
    block, nb = 32, 5
    feats = np.stack([rng.uniform(-25, -5, nb * block), rng.uniform(-10, 10, nb * block),
                      rng.uniform(0, 10, nb * block), np.full(nb * block, 10.0)],
                     1).astype(np.float32)
    feats[7] = np.nan
    band = rng.integers(0, 4, nb)
    got = K.group_argmin(*(torch.as_tensor(a) for a in (lut_c, u_c, v_c, row_group)),
                         torch.as_tensor(feats), torch.as_tensor(band), n_groups, block=block,
                         index=_identity(feats.shape[0]))
    ref = _group_argmin_loop(lut_c, u_c, v_c, row_group, feats, band, n_groups, block)
    np.testing.assert_array_equal(got.numpy().reshape(-1), ref)
    assert got.dtype == torch.int32 and got.reshape(-1)[7] == n_groups - 1


@pytest.mark.parametrize("seed", [0, 1])
def test_group_argmin_slab_holds_exact_argmin_row(seed):
    """On a GMF-consistent scene, the 48-row slab chosen from K1's group
    holds the exact path's argmin row for every valid pixel."""
    kw = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    tables = InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **kw), None,
                             dtype=torch.float32)
    rng = np.random.default_rng(seed)
    n = 600
    inc = rng.uniform(17.0, 60.0, n)
    speed = rng.uniform(0.5, 40.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0 = 10 * np.log10(get_model("gmf_cmod5n")(inc, speed, np.rad2deg(np.abs(direc)),
                                               broadcast=True).numpy() + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731

    lut = tables.co_lut
    lut_c, u_c, v_c, row_group, n_groups = K.build_coarse_arrays(
        lut, tables.co_u, tables.co_v, stride_w=4, stride_p=2)  # ~0.8 m/s, ~5 deg
    keys = torch.as_tensor(_f32_sort_key_np(band_boundaries_f32(tables.co_inc)))
    perm, bob = bucket_by_value(f32(inc), keys, lut.shape[0], K.GROUP_BLOCK)
    pix = torch.stack([f32(s0), f32(anc.real) * 0.5, f32(np.abs(anc.imag)) * 0.5,
                       torch.full((n,), 1.0 / np.float32(0.1))], 1)
    gslot = K.group_argmin(*(torch.as_tensor(a) for a in (lut_c, u_c, v_c, row_group)),
                           pix, bob, n_groups, index=perm).reshape(-1)
    group = torch.empty(n, dtype=torch.int64)
    group[perm[perm >= 0]] = gslot[perm >= 0].to(torch.int64)

    t = tables.to("cpu")
    i_inc = _nearest_index(t.co_inc, f32(inc))
    ma, mz = f32(anc.real), f32(np.abs(anc.imag))
    j = ((t.co_u - ma[:, None, None]) / 2.0) ** 2 + ((t.co_v - mz[:, None, None]) / 2.0) ** 2 \
        + ((t.co_lut[i_inc] - f32(s0)[:, None, None]) / torch.tensor(0.1)) ** 2
    row = torch.div(_first_argmin(j.reshape(n, -1)), lut.shape[2], rounding_mode="floor")
    wp = K.build_direct_arrays(lut, tables.co_u, tables.co_v)[0].shape[1]
    srow0 = torch.clamp(group * K.WGROUP - K.SLAB_MARGIN, 0, wp - K.SLAB_ROWS)
    inside = (row >= srow0) & (row < srow0 + K.SLAB_ROWS)
    assert inside.all(), np.nonzero(~inside.numpy())


def test_kernel_build_dir_in_checkout_or_user_cache(tmp_path, monkeypatch):
    from pathlib import Path

    root = Path(K.__file__).resolve().parents[2]
    assert K._build_dir() == root / "build" / "xsarsea_tpu_torch_kernels"
    # an installed package (no pyproject.toml beside it) builds into the cache
    installed = tmp_path / "site" / "xsarsea_tpu_torch" / "ops" / "inversion_kernels.py"
    monkeypatch.setattr(K, "__file__", str(installed))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert K._build_dir() == tmp_path / "cache" / "xsarsea_tpu_torch" / "kernels"


def test_main_and_experiment_libraries_split_the_sources():
    """The main path's library is built from K1-K4's, the merge's and the
    bucketings' sort's sources,
    the experiment library from the others: the two tuples are disjoint and
    cover every ``csrc/*.cu``; each library's entry points are the
    ``extern "C"`` functions of its own sources; the main module names none
    of the experiment entry points; a build's hash reads a source and the
    headers it includes."""
    import re
    from pathlib import Path

    from xsarsea_tpu_torch.ops import experiment_kernels as E

    main, experiments = set(K._SOURCES), set(E._SOURCES)
    assert main == {"group_argmin.cu", "slab_refine_fused.cu", "slab_refine.cu",
                    "crosspol_argmin.cu", "dual_merge.cu", "bucket_sort.cu"}
    assert main.isdisjoint(experiments)
    assert main | experiments == {p.name for p in K._CSRC.glob("*.cu")}

    def defined(sources):
        text = "".join((K._CSRC / src).read_text() for src in sources)
        return set(re.findall(r'extern "C" [^(]*?\b(xs_\w+)\(', text))

    assert defined(K._SOURCES) == set(K._ENTRIES) | {"xs_error_string"}
    assert defined(E._SOURCES) == set(E._ENTRIES) | {"xs_error_string"}
    main_text = Path(K.__file__).read_text()
    assert not [entry for entry in E._ENTRIES if entry in main_text]
    assert K._included("slab_refine.cu") == ["slab_refine.cu", "inversion_common.cuh"]
    assert K._included("dual_merge.cu") == ["dual_merge.cu"]


def test_wrappers_refuse_other_devices():
    meta = torch.empty((256, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        K.group_argmin(torch.empty(1, 1, 1), torch.empty(1, 1), torch.empty(1, 1),
                       torch.zeros(1, dtype=torch.int32), meta, torch.zeros(1), 1,
                       index=_identity(256))
    with pytest.raises(ValueError, match="device"):
        K.slab_refine_fused(*(torch.empty(1),) * 7, torch.empty((128, 8), device="meta"),
                            *(torch.zeros(1, dtype=torch.int32),) * 3, index=_identity(128))
    with pytest.raises(ValueError, match="device"):
        K.slab_refine(*(torch.empty(1),) * 3, torch.empty((128, 4), device="meta"),
                      *(torch.zeros(1, dtype=torch.int32),) * 3, index=_identity(128))
    with pytest.raises(ValueError, match="device"):
        K.crosspol_argmin(torch.empty(1, 1), torch.empty(1), meta, torch.zeros(1),
                          index=_identity(256))
