"""The fused inversion's kernels (plain PyTorch versions, on the CPU)
against the JAX package's Pallas kernels run in interpret mode, and the
coarse pass's contract with the exact path.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
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
                              torch.ones(nb, dtype=torch.int32)).numpy()
    # expected bit-equal: the same f32 op sequence, the same first-minimum
    # rule and the same NaN poisoning
    np.testing.assert_array_equal(got, ref)
    poisoned = got[0, 0] == 0  # band 2's NaN LUT entry inside block 0's slab
    assert poisoned.any() and (got[0, 1][poisoned] == 0).all()
    flat = got.transpose(0, 2, 1).reshape(-1, 4)
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
                              has_cr=False).numpy()
    keep = np.arange(nb) != 4
    np.testing.assert_array_equal(got[keep, :2], ref[keep, :2])
    assert (got[:, 2:] == 0).all() and (got[4] == 0).all()
    assert K.launch_counts() == {"group_argmin": 0, "slab_refine_fused": 0}


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
                         torch.as_tensor(feats), torch.as_tensor(band), n_groups, block=block)
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
    feats = torch.where((perm >= 0)[:, None], pix[perm.clamp(min=0)], float("nan"))
    gslot = K.group_argmin(*(torch.as_tensor(a) for a in (lut_c, u_c, v_c, row_group)),
                           feats, bob, n_groups).reshape(-1)
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


def test_wrappers_refuse_other_devices():
    meta = torch.empty((256, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        K.group_argmin(torch.empty(1, 1, 1), torch.empty(1, 1), torch.empty(1, 1),
                       torch.zeros(1, dtype=torch.int32), meta, torch.zeros(1), 1)
    with pytest.raises(ValueError, match="device"):
        K.slab_refine_fused(*(torch.empty(1),) * 7, torch.empty((128, 8), device="meta"),
                            *(torch.zeros(1, dtype=torch.int32),) * 3)
