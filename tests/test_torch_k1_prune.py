"""K1's streamed form prunes the wind-speed groups a pixel cannot win
(``xsarsea_tpu_torch/ops/csrc/group_argmin.cu``), on the CPU:

* the lower bound is sound: ``lb(p, g)`` is at most every float32 cost
  ``_cost`` gives in group g, on the full ``gmf_cmod5n`` grid and on the two
  tables of ``tests/test_torch_fused_exact.py``, for priors at radius 0, at
  every annulus edge and one float either side, at 1e-30 and 1e30,
  denormal and NaN, and for dsig of 1e-6 and 1e6; its directed roundings
  are exact against rational arithmetic;
* the plain model of the pruned schedule equals K1's plain version (held
  against the JAX package in ``tests/test_torch_fused_exact.py`` and
  ``tests/test_torch_coarse_seams.py``) bit for bit on K1's seam cases
  lifted to a full grid, on the prune seams and on random blocks, with
  pruning and without; a best cost equal to a bound keeps that group;
* the fused_exact mode's bucketing: single-band blocks, each band's pixels
  in ascending order of their prior's radius, every pixel once;
* the row-group check runs once per table.

Every comparison is exact (tolerance 0): the pruning must not change a bit.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch.ops import coarse_seams
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.bucketing import (_f32_sort_key_np, band_boundaries_f32,
                                             band_of_value, bucket_by_band, bucket_by_band_sorted,
                                             bucket_by_value, f32_sort_key)
from xsarsea_tpu_torch.windspeed import inversion as inv
from xsarsea_tpu_torch.windspeed.inversion import prepare_tables

from test_torch_fused_exact import TABLES

torch.set_num_threads(min(2, torch.get_num_threads()))

F32_MAX = float(np.finfo(np.float32).max)


def _full_grid(**table_kwargs):
    """K1's full-grid operands of the port's ``gmf_cmod5n`` tables and their
    groups' radii."""
    t = prepare_tables("gmf_cmod5n", dtype=torch.float32, **table_kwargs)
    lut_c, u_c, v_c, rg, n_groups = K.build_coarse_arrays(
        np.asarray(t.co_lut), np.asarray(t.co_u), np.asarray(t.co_v), 1, 1)
    return lut_c, u_c, v_c, rg, n_groups, K.build_chunk_radii(u_c, v_c)


_GRIDS = {"high-res": {}, **{f"tables[{i}]": kw for i, (kw, _) in enumerate(TABLES)}}


def _edge_pixels(radii, lut_band, rng):
    """Priors at radius 0, at every annulus edge and one float either side
    (along an axis and at a random direction), at 1e-30, 1e30, denormal and
    NaN; s0 a LUT value of the band, 1/dsig 10, 1e6 and 1e-6; a NaN s0."""
    edges = radii.reshape(-1)
    rho = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                          np.nextafter(edges, np.float32(np.inf)),
                          np.float32([0.0, 1e-30, 1e30, 1e-40, 1.4e-45, np.nan])])
    n = rho.size
    ang = np.where(np.arange(n) % 2 == 0, 0.0, rng.uniform(0, np.pi, n))
    s0 = lut_band.reshape(-1)[rng.integers(0, lut_band.size, n)]
    inv_d = np.choose(np.arange(n) % 3, [np.full(n, 10.0), np.full(n, 1e6), np.full(n, 1e-6)])
    feats = np.stack([s0, rho * np.cos(ang), rho * np.sin(ang), inv_d], 1).astype(np.float32)
    feats[-2, 0] = np.nan  # NaN s0
    feats[-3, 1] = np.float32(1e-40)  # a denormal component beside a normal one
    return feats


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_lower_bound_below_every_cell_cost(grid):
    lut_c, u_c, v_c, _, n_groups, radii = _full_grid(**_GRIDS[grid])
    band = lut_c.shape[0] // 2
    feats = _edge_pixels(radii, lut_c[band], np.random.default_rng(1))
    lb = K.chunk_lower_bounds(torch.as_tensor(feats), torch.as_tensor(radii))
    n_rows = u_c.shape[0]
    u, v, lut = (torch.as_tensor(a) for a in (u_c, v_c, lut_c[band]))
    for p0 in range(0, feats.shape[0], 64):
        f = torch.as_tensor(feats[p0:p0 + 64])[:, :, None, None]
        cost = K._cost(lut, u, v, f[:, 0], f[:, 1], f[:, 2], f[:, 3])  # (n, R, C)
        cost = torch.where(torch.isnan(cost), float("inf"), cost).amin(-1)  # NaN never wins
        pad = torch.full((cost.shape[0], K.WGROUP * n_groups - n_rows), float("inf"))
        gmin = torch.cat([cost, pad], 1).reshape(cost.shape[0], n_groups, K.WGROUP).amin(-1)
        bound = lb[p0:p0 + 64]
        assert not (bound > gmin).any()
        nan_prior = torch.isnan(f[:, 1, 0, 0]) | torch.isnan(f[:, 2, 0, 0])
        assert torch.equal(torch.isnan(bound).all(1), nan_prior)
    assert (lb > 1.0).sum() > lb.numel() // 2  # the bound is not vacuous
    assert (lb[torch.isfinite(lb)] <= F32_MAX).all()


def _exact(x):
    return Fraction(float(x))


def _bracket(lo, hi, exact, representable):
    """lo <= exact <= hi (an infinite end stands beyond the largest float),
    the two at most one float apart, and equal when exact is a float."""
    big = Fraction(F32_MAX)
    assert (_exact(lo) <= exact) if np.isfinite(lo) else (lo < 0 and exact < -big)
    assert (exact <= _exact(hi)) if np.isfinite(hi) else (hi > 0 and exact > big)
    if np.isfinite(lo) and np.isfinite(hi):
        assert hi in (lo, np.nextafter(lo, np.float32(np.inf)))
        assert (lo == hi) == representable


@pytest.mark.parametrize("op", ["mul", "add", "sqrt"])
def test_directed_roundings_exact(op):
    """The emulated __f*_rd / __f*_ru against rational arithmetic, on random
    float32 operands over the whole exponent range with overflow, underflow,
    denormals and exact cases."""
    rng = np.random.default_rng({"mul": 0, "add": 1, "sqrt": 2}[op])
    n = 400
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 38, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 38, n)).astype(np.float32)
    a[:5] = [3e38, 1e-45, 0.0, 2.0, -3e38]
    b[:5] = [3e38, 1e-45, 5.0, 2.0, 3e38]
    if op == "sqrt":
        a = np.abs(a)
        a[5] = 4.0
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    fn = {"mul": lambda up: K._mul_toward(ta, tb, up), "add": lambda up: K._add_toward(ta, tb, up),
          "sqrt": lambda up: K._sqrt_toward(ta, up)}[op]
    lo, hi = fn(False).numpy(), fn(True).numpy()
    for i in range(n):
        if op == "sqrt":  # compare squares
            assert _exact(lo[i]) ** 2 <= _exact(a[i]) <= _exact(hi[i]) ** 2
            assert hi[i] in (lo[i], np.nextafter(lo[i], np.float32(np.inf)))
            continue
        exact = _exact(a[i]) * _exact(b[i]) if op == "mul" else _exact(a[i]) + _exact(b[i])
        near = np.float32(float(exact)) if abs(exact) <= Fraction(F32_MAX) else np.float32(np.inf)
        _bracket(lo[i], hi[i], exact, np.isfinite(near) and _exact(near) == exact)
    assert np.sqrt(np.float32(4.0)) == lo[5] == hi[5] if op == "sqrt" else True
    assert K._mul_toward(torch.tensor([3e38]), torch.tensor([3e38]), False).item() == F32_MAX


def test_group_radii_hold_every_cell():
    _, u_c, v_c, rg, n_groups, radii = _full_grid()
    r = np.sqrt(u_c.astype(np.float64) ** 2 + v_c.astype(np.float64) ** 2)
    for g in range(n_groups):
        cells = r[rg == g]
        assert radii[g, 0] <= cells.min() and cells.max() <= radii[g, 1]
        # outward by at most two floats
        lo, hi = np.float32(cells.min()), np.float32(cells.max())
        for _ in range(2):
            lo, hi = np.nextafter(lo, np.float32(0)), np.nextafter(hi, np.float32(np.inf))
        assert lo <= radii[g, 0] and radii[g, 1] <= hi
    assert radii.dtype == np.float32 and radii.shape == (n_groups, 2)
    assert (np.diff(radii[:, 0]) > 0).all()  # the annuli climb with the speed


# ------------------------------------------------------------ the schedule

def _model_vs_plain(cases, chunk_blocks=4):
    args = cases.args("cpu")
    radii = cases.radii("cpu")
    ref = K._group_argmin_plain(*args, block=K.GROUP_BLOCK, chunk_blocks=chunk_blocks,
                                index=cases.index("cpu"))
    got, swept = K._group_argmin_pruned_model(*args, radii)
    got_all, swept_all = K._group_argmin_pruned_model(*args, radii, prune=False)
    assert torch.equal(got, ref) and torch.equal(got_all, ref)
    flat = got.reshape(-1).numpy()
    assert all(flat[s] == e for s, e in cases.expected.items())
    running = ~np.isnan(cases.feats[:, 0].reshape(-1, K.GROUP_BLOCK)).all(1)
    assert (swept_all[running, 0] == radii.shape[0]).all() and (swept_all[~running] == 0).all()
    assert (swept_all[running, 1] == cases.u_half.shape[0]).all()
    # without pruning every chain sweeps its rows for each pixel with an s0
    px = (~np.isnan(cases.feats[:, 0])).reshape(-1, K.GROUP_BLOCK).sum(1)
    assert (swept_all[:, 2].numpy() == px * cases.u_half.shape[0]).all()
    assert (swept[:, 2] <= swept_all[:, 2]).all()
    assert (swept[:, 0] <= swept_all[:, 0]).all()
    return ref, swept, swept_all


@pytest.mark.parametrize("n_cols", [19, 46, 181])
def test_model_on_lifted_seam_cases(n_cols):
    cases = coarse_seams.full_grid_seam_cases(n_cols)
    assert cases.u_half.shape == (499, n_cols) and cases.n_groups == 32
    _model_vs_plain(cases)


@pytest.mark.parametrize("n_cols", [37, 181])
def test_model_on_prune_seams(n_cols):
    cases = coarse_seams.prune_seam_cases(n_cols)
    ref, swept, swept_all = _model_vs_plain(cases)
    assert int(swept[:, 0].sum()) < int(swept_all[:, 0].sum()) // 2
    # the sorted random blocks need few groups, the unsorted one more
    sorted_blocks = swept[3:11, 0]
    assert float(sorted_blocks.float().mean()) < swept[11, 0]


def test_best_equal_to_a_bound_keeps_that_group():
    """A pixel whose best cost is exactly the next group's bound: the group
    is swept; one float less, and it is not."""
    cases = coarse_seams.prune_seam_cases(37)
    slot, group, best = cases.exact_lb
    block = slot // K.GROUP_BLOCK
    radii = cases.radii("cpu")
    lb = K.chunk_lower_bounds(torch.as_tensor(cases.feats[slot:slot + 1]), radii)[0, group]
    assert lb.item() == best
    counts = []
    for nudge in (0, -1):
        c = coarse_seams.prune_seam_cases(37)
        f = torch.as_tensor(c.feats[slot:slot + 1])
        row, col = [int(x[0]) for x in np.nonzero((c.u_half == c.feats[slot, 1])
                                               & (c.v_half == c.feats[slot, 2]))]
        y = np.float32(c.lut_c[0, row, col] * 1024)
        if nudge:
            y = np.nextafter(y, np.float32(0))
            c.lut_c[0, row, col] = y / np.float32(1024)
        cost = K._cost(torch.as_tensor(c.lut_c[0, row, col]), torch.as_tensor(c.u_half[row, col]),
                       torch.as_tensor(c.v_half[row, col]), *f[0])
        assert (cost.item() == best) == (nudge == 0) and cost.item() <= best
        got, swept = K._group_argmin_pruned_model(*c.args("cpu"), radii)
        assert got.reshape(-1)[slot] == c.expected[slot]
        counts.append(int(swept[block, 0]))
    assert counts[1] < counts[0]


def test_model_on_random_bench_blocks():
    """Bench-scene-like pixels (speed U(0.5, 45), prior noise N(0, 1.5), no
    sigma0 noise, 1/dsig 10) on one band of the high-resolution grid, sorted
    by the prior's radius, then not sorted."""
    lut_c, u_c, v_c, rg, n_groups, radii = _full_grid()
    rng = np.random.default_rng(5)
    n = 3 * K.GROUP_BLOCK
    band = 30
    cells = (rng.integers(3, u_c.shape[0], n), rng.integers(0, u_c.shape[1], n))
    noise = rng.normal(0, 0.75, (n, 2))
    feats = np.stack([lut_c[band][cells], u_c[cells] + noise[:, 0],
                      np.abs(v_c[cells] + noise[:, 1]), np.full(n, 10.0)], 1).astype(np.float32)
    args = [torch.as_tensor(a) for a in (lut_c, u_c, v_c, rg)]
    bob = torch.full((3,), band)
    counts = []
    for order in (np.argsort(np.hypot(feats[:, 1], feats[:, 2]), kind="stable"), np.arange(n)):
        f = torch.as_tensor(feats[order])
        ref = K._group_argmin_plain(*args, f, bob, n_groups, K.GROUP_BLOCK,
                                    index=torch.arange(n))
        got, swept = K._group_argmin_pruned_model(*args, f, bob, n_groups, torch.as_tensor(radii))
        assert torch.equal(got, ref)
        counts.append(int(swept[:, 0].sum()))
    assert counts[0] < counts[1] <= 3 * n_groups


def test_nearest_chunk_order():
    mask = torch.zeros(10, dtype=torch.bool)
    assert K._nearest_chunk(mask, 8) == -1
    mask[[1, 3, 6, 9]] = True
    assert K._nearest_chunk(mask, -1) == 1  # ascending
    assert K._nearest_chunk(mask, 9) == 3  # 3 and 6 equally near 4.5: the lower
    assert K._nearest_chunk(mask, 11) == 6
    assert K._nearest_chunk(mask, 40) == 9


# ------------------------------------------------------ bucketing and checks

def test_sorted_bucketing():
    rng = np.random.default_rng(3)
    n, n_bands, block = 5000, 7, 256
    band = torch.as_tensor(rng.integers(0, n_bands + 1, n))  # n_bands: a sentinel, dropped
    within = torch.as_tensor(rng.uniform(0, 30, n).astype(np.float32))
    within[::97] = float("nan")
    within[5] = float("inf")
    perm, bob = bucket_by_band_sorted(band, within, n_bands, block)
    ref_perm, ref_bob = bucket_by_band(band, n_bands, block)
    assert torch.equal(bob, ref_bob)  # the same blocks: only the order inside a band moves
    valid = perm >= 0
    assert torch.equal(torch.sort(perm[valid]).values, torch.sort(ref_perm[ref_perm >= 0]).values)
    slot_band = bob.repeat_interleave(block)
    assert torch.equal(band[perm[valid]], slot_band[valid])  # single-band blocks
    keys = f32_sort_key(within).to(torch.int64)  # a difference of two int32 keys overflows
    for b in range(n_bands):
        k = keys[perm[valid & (slot_band == b)]]
        assert (torch.diff(k) >= 0).all()  # ascending within the band, NaN last


def test_band_of_value_matches_bucket_by_value():
    grid = np.linspace(17.0, 50.0, 67).astype(np.float32)
    keys = torch.as_tensor(_f32_sort_key_np(band_boundaries_f32(grid)))
    rng = np.random.default_rng(0)
    inc = torch.as_tensor(rng.uniform(10, 60, 3000).astype(np.float32))
    inc[::50] = float("nan")
    perm, bob = bucket_by_value(inc, keys, grid.shape[0], 256)
    band = band_of_value(inc, keys)
    slot_band = bob.repeat_interleave(256)
    valid = perm >= 0
    assert torch.equal(band[perm[valid]], slot_band[valid])


def test_fused_exact_blocks_sorted_by_prior_radius(monkeypatch):
    """The fused_exact closure hands K1 single-band blocks whose pixels
    climb in prior radius; the fused mode keeps its incidence order."""
    t = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, inc_step=2.0,
                       wspd_step=0.4, phi_step=4.0)
    rng = np.random.default_rng(8)
    n = 3000
    inc = rng.uniform(20, 45, n)
    anc = rng.uniform(0.5, 30, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    s0 = rng.uniform(-25, -5, n)
    seen = {}

    def recorder(fn):
        def record(*a, **k):
            seen["k1"] = a, k
            return fn(*a, **k)
        return record

    for name in ("group_argmin", "group_argmin_streamed"):
        monkeypatch.setattr(K, name, recorder(getattr(K, name)))
    for mode in ("fused_exact", "fused"):
        seen.clear()
        inv.invert_pixels(t, inc, s0, s0 - 10, np.full(n, 0.1), anc, mode=mode, device="cpu")
        (_, _, _, _, rows, bob, _), kw = seen["k1"]
        # the blocks' features: the pixel table read through the bucket permutation
        feats = K._slot_rows(rows, kw["index"], 4)
        rho = torch.hypot(feats[:, 1], feats[:, 2]).reshape(bob.shape[0], -1)
        live = ~torch.isnan(feats[:, 0]).reshape(bob.shape[0], -1)
        ordered = all(bool((torch.diff(torch.cat([rho[bob == b][live[bob == b]]])) >= 0).all())
                      for b in torch.unique(bob).tolist())
        assert ordered == (mode == "fused_exact")


def test_row_group_checked_once(monkeypatch):
    """A bad table raises; the fused closure checks its table once, where it
    builds it, and the wrapper does not check a marked table again until it
    changes in place."""
    rg = torch.as_tensor(np.arange(40, dtype=np.int32) // 16)
    K.check_row_group(rg, 3)
    assert K._row_group_checked(rg, 3) and not K._row_group_checked(rg, 4)
    rg[0] = 0  # an in-place write clears the mark
    assert not K._row_group_checked(rg, 3)
    with pytest.raises(ValueError, match="must not decrease"):
        K.check_row_group(rg.flip(0), 3)
    with pytest.raises(ValueError, match="outside"):
        K.check_row_group(rg, 2)
    K.check_row_group(coarse_seams.coarse_row_group(), 32)  # not one group a chunk: taken
    calls = []
    real = K.check_row_group
    monkeypatch.setattr(K, "check_row_group", lambda *a: calls.append(a[1]) or real(*a))
    t = prepare_tables("gmf_cmod5n", dtype=torch.float32, inc_step=2.0, wspd_step=0.4,
                       phi_step=4.0)
    fn = inv._make_fused_invert_fn(t, "cpu", coarse=False)
    assert len(calls) == 1
    x = torch.full((300,), 30.0)
    args = (x, torch.full((300,), -12.0), torch.full((300,), float("nan")),
            torch.full((300,), 0.1), torch.full((300,), 5.0), torch.full((300,), 2.0),
            torch.tensor(0.1))
    fn(*args)
    fn(*args)
    assert len(calls) == 1


def _sweep_grid():
    """K1's operands of the margin sweep's (0.2 m/s, 2 deg) row on the
    high-resolution grid: strides 2 x 2, 250 x 91 cells, 8 rows a group, too
    large for the staged form."""
    t = prepare_tables("gmf_cmod5n", dtype=torch.float32)
    lut_c, u_c, v_c, rg, n_groups = K.build_coarse_arrays(
        np.asarray(t.co_lut), np.asarray(t.co_u), np.asarray(t.co_v), 2, 2)
    assert not K.k1_staged_fits(*u_c.shape) and (rg[:9] == [0] * 8 + [1]).all()
    rng = np.random.default_rng(9)
    n = 3 * K.GROUP_BLOCK
    band = 40
    cells = (rng.integers(0, u_c.shape[0], n), rng.integers(0, u_c.shape[1], n))
    noise = rng.normal(0, 0.75, (n, 2))
    feats = np.stack([lut_c[band][cells] + rng.normal(0, 0.3, n), u_c[cells] + noise[:, 0],
                      np.abs(v_c[cells] + noise[:, 1]), np.full(n, 10.0)], 1).astype(np.float32)
    order = np.argsort(np.hypot(feats[:, 1], feats[:, 2]), kind="stable")
    feats[:2 * K.GROUP_BLOCK] = feats[order[:2 * K.GROUP_BLOCK]]  # two sorted blocks, one not
    return coarse_seams.CoarseSeamCases(lut_c=lut_c, u_half=u_c, v_half=v_c, row_group=rg,
                                        feats=feats, band_of_block=np.full(3, band, np.int32),
                                        n_groups=n_groups)


@pytest.mark.parametrize("grid", ["seams-19", "seams-46", "seams-181", "sweep"])
def test_model_on_row_groups_not_one_a_chunk(grid):
    """Grids whose groups do not fill one 16-row chunk each: K1's coarse
    seam cases (2-3 rows a group, ties across chunks and chains) and the
    margin sweep's (0.2, 2, 8) grid, whose groups span two chunks."""
    cases = (_sweep_grid() if grid == "sweep"
             else coarse_seams.coarse_seam_cases(int(grid.split("-")[1])))
    assert cases.radii("cpu").shape[0] != cases.n_groups
    _, swept, swept_all = _model_vs_plain(cases)
    if grid == "sweep":
        assert int(swept[:, 0].sum()) < int(swept_all[:, 0].sum())


def test_fused_mode_streams_a_coarse_grid_too_large_for_the_staged_form(monkeypatch):
    """The fused mode at the margin sweep's (0.2 m/s, 2 deg, 8 rows) row
    takes K1's streamed form with the grid's radii, and its winds equal the
    fused_exact mode's on the sweep's adversarial pixels (two incidence
    bands, 512 px)."""
    from xsarsea_tpu_torch.scripts import sweep_margin

    t = prepare_tables("gmf_cmod5n", dtype=torch.float32)
    px = sweep_margin.make_pixels(512, torch.device("cpu"))
    px[0] = torch.where(torch.arange(512) % 2 == 0, 30.0, 41.0)
    dsig = torch.tensor(0.1)
    seen = []
    real = K.group_argmin_streamed
    monkeypatch.setattr(K, "group_argmin_streamed",
                        lambda *a, **k: seen.append(k["radii"].shape) or real(*a, **k))
    monkeypatch.setattr(inv, "_COARSE_DW", 0.2)
    monkeypatch.setattr(inv, "_COARSE_DPHI", 2.0)
    monkeypatch.setattr(inv, "_COARSE_MARGIN", 8)
    got = inv._make_fused_invert_fn(t, "cpu")(*px, dsig)
    assert seen == [(16, 2)]  # 250 rows
    ref = inv._make_fused_invert_fn(t, "cpu", coarse=False)(*px, dsig)
    for a, b in zip(got, ref):
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
