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
    assert keys.dtype == np.int32  # the reference's unsigned key less 2**31
    np.testing.assert_array_equal(keys.astype(np.int64),
                                  jpi._f32_sort_key_np(ref).astype(np.int64) - 2 ** 31)
    assert B.band_boundaries_f32(grid[::-1]) is None


_I32 = np.iinfo(np.int32)


def test_sort_key_tensor_matches_numpy_and_is_monotone():
    v = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.5, 7.0, np.inf, np.nan], np.float32)
    got = B.f32_sort_key(torch.as_tensor(v)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, B._f32_sort_key_np(v))
    assert got[0] == got[7] == _I32.min and got[8] == _I32.max
    assert (np.diff(got[1:7]) > 0).all()


def _bits(u):
    return np.asarray(u, np.uint64).astype(np.uint32).view(np.float32)


_TINY = np.finfo(np.float32).tiny
_MAX = np.finfo(np.float32).max
# value sets for the 32-bit key: the special values, the denormals (both
# signs, the whole range in steps), random bit patterns (NaN payloads of
# both signs among them) and ladders of adjacent floats
_KEY_SETS = {
    "specials": np.array([-np.inf, -_MAX, -1.0, -_TINY, -_bits(1)[()], -0.0, 0.0, _bits(1)[()],
                          _TINY, 1.0, _MAX, np.inf, np.nan, -np.nan], np.float32),
    "denormals": np.concatenate([_bits(np.arange(0, 2 ** 23, 4099)),
                                 -_bits(np.arange(0, 2 ** 23, 4099)), _bits([2 ** 23 - 1])]),
    "random_bits": _bits(np.random.default_rng(5).integers(0, 2 ** 32, 200_000)),
    "ladders": np.concatenate([_bits(np.arange(b - 300, b + 300)) for b in
                               (0x00800000, 0x3F800000, 0x7F7FFF00, 0x80000000 + 300,
                                0x80800000, 0xBF800000)]),
}


@pytest.mark.parametrize("name", sorted(_KEY_SETS))
def test_f32_sort_key_holds_the_unsigned_key_order(name):
    """The 32-bit key is ``_f32_sort_key_np``'s, the reference's unsigned key
    less 2**31, so torch's order of it is the unsigned key's: monotone in
    the value, -0 below +0, +-inf first, NaN last."""
    v = _KEY_SETS[name]
    key = B.f32_sort_key(torch.as_tensor(v)).numpy()
    assert key.dtype == np.int32
    np.testing.assert_array_equal(key, B._f32_sort_key_np(v))
    unsigned = jpi._f32_sort_key_np(v).astype(np.int64)
    np.testing.assert_array_equal(key.astype(np.int64), unsigned - 2 ** 31)
    assert (key[np.isinf(v)] == _I32.min).all() and (key[np.isnan(v)] == _I32.max).all()
    finite = np.isfinite(v)
    fk, fv = key[finite], v[finite]
    assert (fk > _I32.min).all() and (fk < _I32.max).all()
    by_key = np.argsort(fk, kind="stable")
    assert (np.diff(fv[by_key]) >= 0).all()  # monotone in the value
    # equal values under distinct keys are -0 and +0 alone, -0 first
    same = np.diff(fv[by_key]) == 0
    steps = np.diff(fk[by_key]) > 0
    assert (fv[by_key][1:][same & steps] == 0).all()
    assert (np.signbit(fv[by_key][:-1][same & steps])).all()


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


# the sync-free assembly against the boolean-mask one it replaced: each case
# through the three bucketings, bit for bit
_CASES = ("empty_middle", "empty_trailing", "sentinels", "all_sentinels", "n_below_block",
          "single_band", "empty")
# band counts at the edges of a key width (the narrow sort covers the bit
# length of n_bands), and heavy ties
_WIDTH_CASES = ("n_bands_1", "n_bands_2k_minus_1", "n_bands_2k", "n_bands_2k_plus_1",
                "heavy_ties")


def _band_case(case):
    """``(band, n_bands, block)`` of a case; a band of ``n_bands`` is a
    sentinel."""
    rng = np.random.default_rng(len(case))
    if case == "n_bands_1":
        return rng.integers(0, 2, 600), 1, 64
    if case.startswith("n_bands_2k"):
        n_bands = {"n_bands_2k_minus_1": 127, "n_bands_2k": 128, "n_bands_2k_plus_1": 129}[case]
        return rng.integers(0, n_bands + 1, 3000), n_bands, 32
    if case == "heavy_ties":
        return rng.choice([0, 1, 2, 511, 1000], 5000), 1000, 64
    if case == "empty_middle":
        return rng.choice([0, 1, 2, 5, 6, 8, 9], 1000), 10, 64
    if case == "empty_trailing":
        return rng.integers(0, 7, 700), 12, 64
    if case == "sentinels":
        return rng.integers(0, 8, 900), 7, 64
    if case == "all_sentinels":
        return np.full(300, 5), 5, 64
    if case == "n_below_block":
        return rng.integers(0, 6, 37), 6, 64
    if case == "single_band":
        return np.zeros(500, np.int64), 1, 64
    return np.zeros(0, np.int64), 4, 64


# route -> the bucketing it runs ("by_band" with a payload, "by_band_iota"
# without)
_ROUTES = {"by_value": "bucket_by_value", "by_band": "bucket_by_band",
           "by_band_iota": "bucket_by_band", "by_band_sorted": "bucket_by_band_sorted"}


def _bucket(route, case, reference=False):
    """A case's bucketing by ``route``: the port's, or (``reference``) the
    int64 sort's it replaced."""
    import _bucket_copies

    fn = getattr(_bucket_copies, "int64_" + _ROUTES[route]) if reference \
        else getattr(B, _ROUTES[route])
    band, n_bands, block = _band_case(case)
    rng = np.random.default_rng(7)
    n = band.shape[0]
    if route == "by_band":
        return fn(torch.as_tensor(band), n_bands, block, torch.as_tensor(rng.permutation(n) + 3))
    if route == "by_band_iota":
        return fn(torch.as_tensor(band), n_bands, block)
    if route == "by_band_sorted":
        within = rng.integers(0, 50, n).astype(np.float32)  # ties within a band
        within[::7] = np.nan
        return fn(torch.as_tensor(band), torch.as_tensor(within), n_bands, block)
    # band b's values lie nearest b on the grid 0, 1, ..., n_bands - 1 (on
    # it, with heavy ties); a sentinel's value is NaN, which sorts into the
    # last band
    jitter = 0.0 if case == "heavy_ties" else rng.uniform(-0.3, 0.3, n)
    vals = (band + jitter).astype(np.float32)
    vals[band >= n_bands] = np.nan
    bounds = B.band_boundaries_f32(np.arange(n_bands, dtype=np.float32))
    keys = np.zeros(0, np.int32) if bounds is None else B._f32_sort_key_np(bounds)
    return fn(torch.as_tensor(vals), torch.as_tensor(keys), n_bands, block)


@pytest.mark.parametrize("route", ["by_value", "by_band", "by_band_sorted"])
@pytest.mark.parametrize("case", _CASES)
def test_sync_free_assembly_equals_the_masked_one(case, route, monkeypatch):
    from _bucket_copies import masked_bucketing

    band, n_bands, block = _band_case(case)
    perm, bob = _bucket(route, case)
    with monkeypatch.context() as m:
        masked_bucketing(m)
        ref_perm, ref_bob = _bucket(route, case)
    assert perm.dtype == ref_perm.dtype == torch.int64 and perm.is_contiguous()
    assert torch.equal(perm, ref_perm)
    assert bob.dtype == ref_bob.dtype and torch.equal(bob, ref_bob)
    assert bob.shape[0] == perm.shape[0] // block
    assert 0 <= int(bob.min()) and int(bob.max()) < n_bands


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("case", _CASES + _WIDTH_CASES)
def test_narrow_sort_equals_the_int64_sort(case, route):
    """Each bucketing's narrow sort (32-bit keys and payload, over the bits
    the keys hold) gives ``perm`` and ``band_of_block`` bit-identical to the
    stable int64 sort it replaced, and counts its sorts and key bits."""
    from xsarsea_tpu_torch.utils import spans

    n_bands = _band_case(case)[1]
    before = spans.counters()
    perm, bob = _bucket(route, case)
    after = spans.counters()
    ref_perm, ref_bob = _bucket(route, case, reference=True)
    assert perm.dtype == ref_perm.dtype == torch.int64 and torch.equal(perm, ref_perm)
    assert bob.dtype == ref_bob.dtype and torch.equal(bob, ref_bob)
    bits = {"by_value": 32, "by_band_sorted": 32 + n_bands.bit_length()}.get(
        route, n_bands.bit_length())
    assert after["narrow_sorts"] - before["narrow_sorts"] == 1 + (route == "by_band_sorted")
    assert after["sort_bits"] - before["sort_bits"] == bits


@pytest.mark.parametrize("route", ["by_band", "by_band_iota", "by_band_sorted"])
@pytest.mark.parametrize("outside", ["above", "negative"])
def test_a_band_outside_the_range_is_a_sentinel(outside, route):
    """A band outside ``[0, n_bands)``, far past the key bits ``n_bands``
    needs or below 0, is dropped as the sentinel ``n_bands`` is: the
    bucketing equals the int64 sort's of the bands with those set to
    ``n_bands``."""
    import _bucket_copies as C

    band, as_sentinel, n_bands, block = C.outside_band_case(outside, 4000, 100, seed=11)
    got = C.bucket_route(B, route, band, n_bands, block, seed=12)
    ref = C.bucket_route(C, route, as_sentinel, n_bands, block, seed=12, reference=True)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert int((got[0] >= 0).sum()) == int((as_sentinel < n_bands).sum())


@pytest.mark.parametrize("cross_axis", ["shared", "own"])
def test_a_piece_sorts_over_its_keys_bits(cross_axis):
    """A fused-tail piece sorts twice, the incidence key's 32 bits and the
    re-bucketing's bit length of n_inc * n_wgroups; an unfused one also the
    crosspol bands' bit length."""
    from xsarsea_tpu_torch.utils import spans

    kw = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
    cr_kw = kw if cross_axis == "shared" else {**kw, "inc_step": 1.5}
    tables = InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **kw),
                             get_model("gmf_s1_v2").to_lut(units="dB", **cr_kw),
                             dtype=torch.float32)
    rng = np.random.default_rng(4)
    n = 300
    inc = rng.uniform(20.0, 45.0, n)
    s0 = rng.uniform(-25.0, -5.0, n)
    anc = rng.uniform(3.0, 15.0, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    before = spans.counters()
    invert_pixels(tables, inc, 10 ** (s0 / 10), 10 ** ((s0 - 12) / 10), np.full(n, 0.3), anc,
                  mode="fused", device="cpu")
    after = spans.counters()
    pieces = after["pieces"] - before["pieces"]
    n_wgroups = -(-len(tables.co_wspd) // 16)
    bits = 32 + (len(tables.co_inc) * n_wgroups).bit_length()
    sorts = 2
    if cross_axis == "own":
        bits += len(tables.cr_inc).bit_length()
        sorts = 3
    assert pieces >= 1
    assert after["narrow_sorts"] - before["narrow_sorts"] == sorts * pieces
    assert after["sort_bits"] - before["sort_bits"] == bits * pieces
