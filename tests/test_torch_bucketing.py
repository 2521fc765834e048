"""The port's nearest-index lookup and pixel bucketing against the JAX
package and numpy (``np.argmin(|grid - v|)``, first minimum).

Bucketing has no tolerance: band assignments are integers and must be
identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu_torch.ops import bucketing as B
from xsarsea_tpu_torch.windspeed import inversion as inv
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_pixels
from xsarsea_tpu_torch.models import get_model

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))


def _np_nearest(grid, vals):
    with np.errstate(invalid="ignore"):
        return np.array([np.argmin(np.abs(grid - v)) for v in vals])


def _values(grid, seed, n=400):
    rng = np.random.default_rng(seed)
    g = np.asarray(grid, np.float64)
    mids = (g[:-1] + g[1:]) / 2  # exact ties -> lower index
    return np.concatenate([rng.uniform(g.min() - 3, g.max() + 3, n), mids[:20], g[:10],
                           [np.nan, np.inf, -np.inf, g.min() - 100, g.max() + 100]])


GRIDS = {
    "uniform_f64": np.linspace(16.0, 66.0, 51),
    "uniform_f32": np.linspace(16.0, 66.0, 501).astype(np.float32),
    "nonuniform": np.sort(np.r_[np.linspace(16.0, 66.0, 37), [20.1, 33.7, 50.2]]),
    "descending": np.linspace(16.0, 66.0, 41)[::-1].copy(),
    "nonuniform_desc": np.sort(np.r_[np.linspace(16.0, 66.0, 37), [20.1, 33.7]])[::-1].copy(),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_nearest_index_sorted_matches_argmin_and_jax(name):
    grid = GRIDS[name]
    vals = _values(grid, seed=len(name)).astype(grid.dtype)
    got = B.nearest_index_sorted(torch.as_tensor(grid), torch.as_tensor(vals)).numpy()
    ref = np.asarray(jpi.nearest_index_sorted(jnp.asarray(grid), jnp.asarray(vals)))
    np.testing.assert_array_equal(got, ref)
    finite = np.isfinite(vals)
    np.testing.assert_array_equal(got[finite], _np_nearest(grid, vals[finite]))
    assert (got[~finite] == 0).all()
    assert got.dtype == np.int32


def test_nearest_index_uniform_matches_jax():
    vals = _values(np.linspace(16, 66, 51), seed=3)
    got = B.nearest_index_uniform(16.0, 1.0, 51, torch.as_tensor(vals)).numpy()
    ref = np.asarray(jpi.nearest_index_uniform(16.0, 1.0, 51, jnp.asarray(vals)))
    np.testing.assert_array_equal(got, ref)
    two = B.nearest_index_uniform(0.0, 1.0, 2, torch.tensor([-5.0, 0.4, 0.6, 9.0]))
    np.testing.assert_array_equal(two.numpy(), [0, 0, 1, 1])


@pytest.mark.parametrize("grid", [np.linspace(16.0, 66.0, 501), np.linspace(17, 61, 45),
                                  np.sort(np.r_[np.linspace(16.0, 66.0, 37), [20.1, 33.7]])])
def test_band_boundaries_and_sort_keys_match_jax(grid):
    got = B.band_boundaries_f32(grid)
    ref = jpi.band_boundaries_f32(grid)
    np.testing.assert_array_equal(got, ref)
    keys = B._f32_sort_key_np(got)
    assert keys.dtype == np.int64
    np.testing.assert_array_equal(keys, jpi._f32_sort_key_np(ref).astype(np.int64))
    assert B.band_boundaries_f32(grid[::-1]) is None


def test_sort_key_tensor_matches_numpy_and_is_monotone():
    v = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.5, 7.0, np.inf, np.nan], np.float32)
    got = B.f32_sort_key(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, B._f32_sort_key_np(v))
    assert got[0] == 0 and got[7] == 0 and got[8] == 0xFFFFFFFF
    assert (np.diff(got[1:7]) >= 0).all()


def _check_buckets(perm, band_of_block, band, block, n):
    perm, bob = perm.numpy(), band_of_block.numpy()
    real = perm[perm >= 0]
    assert sorted(real.tolist()) == list(range(n))  # every pixel exactly once
    assert perm.shape[0] % block == 0 and bob.shape[0] == perm.shape[0] // block
    for b in range(bob.shape[0]):
        blk = perm[b * block:(b + 1) * block]
        assert (band[blk[blk >= 0]] == bob[b]).all()  # every pixel in a block of its band


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_by_value_bands_equal_nearest(seed):
    grid = np.linspace(16.0, 66.0, 101).astype(np.float32)
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.uniform(10, 70, 3000),
                           (grid[:-1] / 2 + grid[1:] / 2)[:50],  # near-ties
                           [np.inf, -np.inf]]).astype(np.float32)
    keys = torch.as_tensor(B._f32_sort_key_np(B.band_boundaries_f32(grid)))
    perm, bob = B.bucket_by_value(torch.as_tensor(vals), keys, n_bands=101, block=64)
    band = B.nearest_index_sorted(torch.as_tensor(grid), torch.as_tensor(vals)).numpy()
    _check_buckets(perm, bob, band, 64, vals.shape[0])
    np.testing.assert_array_equal(band[:-2], _np_nearest(grid, vals[:-2]))


def test_bucket_by_value_sends_nan_last_and_inf_first():
    grid = np.linspace(16.0, 66.0, 11).astype(np.float32)
    vals = np.array([np.nan, 30.0, np.inf, -np.inf, np.nan], np.float32)
    keys = torch.as_tensor(B._f32_sort_key_np(B.band_boundaries_f32(grid)))
    perm, bob = B.bucket_by_value(torch.as_tensor(vals), keys, n_bands=11, block=4)
    perm, bob = perm.numpy(), bob.numpy()
    band_of = {int(p): int(bob[i // 4]) for i, p in enumerate(perm) if p >= 0}
    assert band_of[0] == band_of[4] == 10 and band_of[2] == band_of[3] == 0
    assert band_of[1] == _np_nearest(grid, [30.0])[0] == 3


def test_bucket_by_band_payload_and_sentinels():
    rng = np.random.default_rng(2)
    n, n_bands, block = 1000, 7, 64
    band = rng.integers(0, n_bands + 1, n)  # n_bands is a sentinel key
    payload = rng.permutation(n)
    perm, bob = B.bucket_by_band(torch.as_tensor(band), n_bands, block,
                                 values=torch.as_tensor(payload))
    perm, bob = perm.numpy(), bob.numpy()
    real = band < n_bands
    placed = perm[perm >= 0]
    assert sorted(placed.tolist()) == sorted(payload[real].tolist())
    band_of_payload = dict(zip(payload.tolist(), band.tolist()))
    for b in range(bob.shape[0]):
        blk = perm[b * block:(b + 1) * block]
        assert all(band_of_payload[p] == bob[b] for p in blk[blk >= 0])
    # the JAX package's block structure: same block count and band per block
    _, jbob = jpi.bucket_by_band(jnp.asarray(band, jnp.int32), n_bands=n_bands, block=block,
                                 values=jnp.asarray(payload, jnp.int32))
    np.testing.assert_array_equal(bob, np.asarray(jbob))


def test_nan_incidence_same_outputs_through_both_bucketing_routes(monkeypatch):
    """NaN-incidence pixels land in the LAST band through bucket_by_value
    and in band 0 through nearest_index_sorted + bucket_by_band. Both
    routes must give identical outputs: NaN for those pixels, and the same
    bits everywhere else."""
    kw = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    tables = InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **kw),
                             get_model("gmf_s1_v2").to_lut(units="dB", **kw),
                             dtype=torch.float32)
    rng = np.random.default_rng(9)
    n = 200
    inc = rng.uniform(17.0, 60.0, n)
    speed = rng.uniform(1.0, 25.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0c = 10 * np.log10(get_model("gmf_cmod5n")(inc, speed, np.rad2deg(np.abs(direc)),
                                                broadcast=True).numpy() + 1e-15)
    s0x = 10 * np.log10(get_model("gmf_s1_v2")(inc, speed, broadcast=True).numpy() + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    inc[[0, 5, 17, 100]] = np.nan
    args = (inc, s0c, s0x, np.full(n, 0.3), anc)

    by_value = invert_pixels(tables, *args, mode="fused", device="cpu")
    tables._invert_fn_cache.clear()
    monkeypatch.setattr(inv, "band_boundaries_f32", lambda grid: None)
    by_band = invert_pixels(tables, *args, mode="fused", device="cpu")
    for a, b in zip(by_value, by_band):
        np.testing.assert_array_equal(a, b)
        assert np.isnan(a[[0, 5, 17, 100]].real).all()
        assert (a[[0, 5, 17, 100]].imag == 0).all()
