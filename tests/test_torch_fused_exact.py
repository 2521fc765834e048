"""The ``fused_exact`` mode (the reference's ``pallas_exact``) and what it
adds to the kernels, on the CPU (their plain versions), against the JAX
package:

* port ``fused_exact`` against JAX ``mode="pallas_exact_interpret"`` on the
  same table arrays: the same winner on every pixel, except at the phi =
  +-180 deg tie (tests/_parity.py) and where JAX's expanded-form first pass
  drifts from its own exact path; every differing pixel must be one of those;
* port ``fused_exact`` against port ``fused`` and ``exact``; own-axes tables
  (K3 and K4 after the 32-row slab) and copol-only tables;
* K1's plain version on the full grid (stride 1) against a numpy brute
  force; K2's and K3's plain versions at 32 slab rows against the JAX
  Pallas kernels in interpret mode on the slab sweep's seam cases;
* the closure cache keyed by the sweepable knobs; the margin sweep's script.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.slab_seams import seam_cases, tie_sets
from xsarsea_tpu_torch.windspeed import inversion as inv
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_from_model, \
    invert_pixels

from _parity import assert_equal_modulo_pi_ties
from test_torch_inversion import F32_TRIG, _db, _jax_tables, _port_tables, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

# tests/test_pallas_inversion.py:77-81's two resolutions; the finer one's
# pixels lie in an incidence window (few bands: the JAX interpreter's time
# grows with the blocks)
TABLES = [(dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0), (17.0, 60.0)),
          (dict(inc_step=1.0, wspd_step=0.2, phi_step=2.5), (31.6, 33.4))]


def _luts(kw):
    return (jax_model("gmf_cmod5n").to_lut(units="dB", **kw),
            jax_model("gmf_s1_v2").to_lut(units="dB", **kw))


def _scene(seed, inc_range, n=300, dsig_cr=None):
    """GMF sigma0 and a noisy ancillary wind, with NaN pixels of each kind
    (tests/test_pallas_inversion.py:99-103)."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(*inc_range, n)
    speed = rng.uniform(1.0, 28.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0_co = np.array(jax_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc)),
                                             broadcast=True))
    s0_cr = np.array(jax_model("gmf_s1_v2")(inc, speed, broadcast=True))
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    dsig = rng.uniform(0.1, 1.0, n) if dsig_cr is None else np.full(n, dsig_cr)
    inc[0] = np.nan
    s0_co[1] = np.nan
    anc[2] = np.nan
    s0_cr[3] = np.nan
    return inc, _db(s0_co), _db(s0_cr), dsig, anc


def _differ(got, ref, rel=F32_TRIG):
    """Pixels where ``got`` is not ``ref`` up to ``rel`` and the phi tie."""
    same = (np.abs(got - ref) <= rel * np.abs(ref)) | (np.isnan(got) & np.isnan(ref))
    tie = (np.abs(got - np.conj(ref)) <= rel * np.abs(ref)) & (np.abs(ref.imag) < 1e-4)
    return ~(same | tie)


@pytest.mark.parametrize("case", range(len(TABLES)))
def test_fused_exact_matches_jax_pallas_exact(case):
    kw, inc_range = TABLES[case]
    jt, lut_co, lut_cr = _jax_tables(jnp.float32, luts=_luts(kw))
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    args = _scene(case, inc_range)
    K.reset_launch_counts()
    got = invert_pixels(tt, *args, mode="fused_exact", device="cpu")
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)  # plain versions on the CPU
    ref = jinv.invert_pixels(jt, *args, mode="pallas_exact_interpret")
    ref_exact = jinv.invert_pixels(jt, *args, mode="exact")
    for g, r, e in zip(got, ref, ref_exact):
        assert g.dtype == np.complex64
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        # a pixel may differ only where JAX's expanded-form first pass drifted
        # off its own exact path
        drift = _differ(r, e)
        assert not (_differ(g, r) & ~drift).any()
    assert np.isnan(got[0][[0, 1, 2]]).all() and np.isnan(got[1][[0, 2, 3]]).all()


@pytest.mark.parametrize("seed", [0, 11])
def test_fused_exact_against_fused_and_exact(seed):
    """Same cost form as ``fused``, so the same winners wherever the coarse
    pass lands within its margin; against ``exact`` (which divides by dsig
    where the fused modes multiply by 1/dsig) equal up to the tie on the
    scene of tests/test_torch_inversion.py (dsig 0.3), and within the fused
    path's tolerance with random dsig_cr."""
    jt, lut_co, lut_cr = _jax_tables(jnp.float32)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    args = _scene(seed, (17.0, 50.0), dsig_cr=0.3 if seed == 11 else None)
    fe = invert_pixels(tt, *args, mode="fused_exact", device="cpu")
    fused = invert_pixels(tt, *args, mode="fused", device="cpu")
    exact = invert_pixels(tt, *args, mode="exact", device="cpu")
    for a, b in zip(fe, fused):
        np.testing.assert_array_equal(a, b)
    if seed == 11:
        for a, e in zip(fe, exact):
            assert_equal_modulo_pi_ties(a, e)
    m = ~np.isnan(np.abs(exact[0]))
    sp = np.abs(np.abs(exact[0][m]) - np.abs(fe[0][m]))
    assert np.mean(sp > 1e-6) < 0.02 and np.sqrt(np.mean(sp ** 2)) < 1e-3


def test_fused_exact_own_axes_tables_k3_k4_tail():
    """A crosspol LUT on its own incidence axis: K1 on the full grid, K3 on
    32 rows, the decode, K4; against JAX ``pallas_exact_interpret``."""
    lut_co = jax_model("gmf_cmod5n").to_lut(units="dB", inc_step=0.5, wspd_step=0.5,
                                            phi_step=5.0)
    lut_cr = jax_model("gmf_s1_v2").to_lut(units="dB", inc_step=0.7, wspd_step=0.5,
                                           phi_step=5.0)
    jt = jinv.InversionTables(lut_co, lut_cr, dtype=jnp.float32)
    c, r = lut_co.coords, lut_cr.coords
    tt = InversionTables.from_arrays(jt.co_lut, c["incidence"], c["wspd"], c["phi"], jt.cr_lut,
                                     r["incidence"], r["wspd"], dtype=torch.float32)
    args = _scene(3, (30.0, 36.0))
    calls = []
    originals = {name: getattr(K, name) for name in ("slab_refine", "slab_refine_fused",
                                                      "crosspol_argmin")}
    try:
        for name, fn in originals.items():
            setattr(K, name, lambda *a, _n=name, _f=fn, **k: calls.append((_n, k)) or _f(*a, **k))
        got = invert_pixels(tt, *args, mode="fused_exact", device="cpu")
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
    assert [n for n, _ in calls] == ["slab_refine", "crosspol_argmin"]
    assert calls[0][1]["n_rows"] == K.EXACT_SLAB_ROWS == 32
    ref = jinv.invert_pixels(jt, *args, mode="pallas_exact_interpret")
    for g, r_ in zip(got, ref):
        assert_parity(g, r_, F32_TRIG)


def test_fused_exact_copol_only():
    jt, lut_co, lut_cr = _jax_tables(jnp.float32, cr=False)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    inc, s0, _, _, anc = _scene(7, (30.0, 36.0))
    nanv = np.full(inc.shape, np.nan)
    args = (inc, s0, nanv, nanv, anc)
    got = invert_pixels(tt, *args, mode="fused_exact", device="cpu")
    assert np.isnan(np.abs(got[1])).all()
    assert_equal_modulo_pi_ties(got[0], invert_pixels(tt, *args, mode="exact", device="cpu")[0])
    assert_parity(got[0], jinv.invert_pixels(jt, *args, mode="pallas_exact_interpret")[0],
                  F32_TRIG)


def test_invert_from_model_fused_exact():
    """The mode through the public facade (the lazy source, device dB)."""
    rng = np.random.default_rng(5)
    ny, nx = 10, 17
    inc = np.linspace(20.0, 45.0, nx)[None, :].repeat(ny, 0)
    speed = rng.uniform(2.0, 25.0, (ny, nx))
    direc = rng.uniform(-np.pi, np.pi, (ny, nx))
    s0_co = np.asarray(jax_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc)),
                                               broadcast=True))
    s0_cr = np.asarray(jax_model("gmf_s1_v2")(inc, speed, broadcast=True))
    kw = dict(ancillary_wind=speed * np.exp(1j * direc), model=("gmf_cmod5n", "gmf_s1_v2"),
              device="cpu", dtype=torch.float32, inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    fe = invert_from_model(inc, s0_co, s0_cr, mode="fused_exact", **kw)
    fused = invert_from_model(inc, s0_co, s0_cr, mode="fused", **kw)
    for a, b in zip(fe, fused):
        assert a.shape == (ny, nx)
        np.testing.assert_array_equal(a, b)
    assert inv._resolve_mode("fused_exact", inv.prepare_tables(
        "gmf_cmod5n", dtype=torch.float32, inc_step=1.0, wspd_step=1.0, phi_step=10.0),
        "cpu") == "fused_exact"


# ----------------------------------------------------------------- the kernels

def test_group_argmin_plain_full_grid_matches_brute_force():
    """K1's plain version at stride 1 (every LUT row and column): the first
    group holding the least finite cost, NaN entries never winning, the last
    group for a pixel with no finite cost; padding rows give it too."""
    rng = np.random.default_rng(4)
    n_inc, n_wspd, n_phi = 3, 53, 19
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    lut[1, 20, 4] = np.nan
    lut[2, :, 7] = np.nan
    u = rng.uniform(-20, 20, (n_wspd, n_phi)).astype(np.float32)
    v = rng.uniform(-20, 20, (n_wspd, n_phi)).astype(np.float32)
    lut[0, 40, 3], u[40, 3], v[40, 3] = lut[0, 8, 3], u[8, 3], v[8, 3]  # an exact tie
    lut_c, u_c, v_c, row_group, n_groups = K.build_coarse_arrays(lut, u, v, 1, 1)
    assert lut_c.shape == lut.shape and n_groups == 4
    nb = 6
    band = rng.integers(0, n_inc, nb).astype(np.int64)
    feats = np.stack([rng.uniform(-35, 0, nb * 256), rng.uniform(-10, 10, nb * 256),
                      rng.uniform(-10, 10, nb * 256), np.full(nb * 256, 3.0)], 1)
    feats = feats.astype(np.float32)
    band[0] = 0
    feats[0, :3] = lut[0, 8, 3], u[8, 3] * 0.5, v[8, 3] * 0.5  # cost 0 at rows 8 and 40
    feats[1, 3] = np.inf  # every (l - s0) * inf is +-inf or NaN: no finite cost
    feats[2, 0] = np.nan
    feats[300:] = np.nan  # padding, whole and partial blocks
    got = K.group_argmin(*(torch.as_tensor(a) for a in (lut_c, u_c, v_c, row_group)),
                         torch.as_tensor(feats), torch.as_tensor(band), n_groups,
                         index=torch.arange(nb * 256)).numpy()
    for p in range(nb * 256):
        s0, ma2, mz2, inv_d = (np.float32(x) for x in feats[p])
        with np.errstate(invalid="ignore", over="ignore"):
            j = ((((lut[band[p // 256]] - s0) * inv_d) ** 2 + (u * np.float32(0.5) - ma2) ** 2)
                 + (v * np.float32(0.5) - mz2) ** 2)
        j = np.where(np.isnan(j), np.inf, j)
        want = n_groups - 1
        if np.isfinite(j).any() and j.min() < np.inf:
            want = int(np.argmin(j.min(axis=1))) // K.WGROUP
        assert got.reshape(-1)[p] == want, p
    assert got.reshape(-1)[0] == 0 and got.reshape(-1)[1] == n_groups - 1


@pytest.mark.parametrize("n_phi", [37, 72, 181])
def test_slab_plain_32_rows_matches_pallas_on_seams(n_phi):
    """K3 and K2's plain versions on a 32-row slab, on the seam cases built
    for that height: bit-equal to ``slab_refine_pallas`` and
    ``slab_refine_fused_pallas`` with ``n_rows=32`` in interpret mode, and at
    the cases' designed answers."""
    cases = seam_cases(n_phi=n_phi, n_rows=K.EXACT_SLAB_ROWS)
    assert cases.n_rows == 32
    got3 = K.slab_refine(*cases.k3_args("cpu"), n_rows=32, index=cases.index("cpu")).numpy()
    flat = got3
    got3 = got3.reshape(-1, K.SLAB_BLOCK)  # the reference's blocks
    assert all(flat[s] == e for s, e in cases.expected.items())
    assert len(cases.expected) > 700
    live = cases.vmask == 1
    jdirect = jpi.build_direct_arrays(cases.lut, cases.u, cases.v)
    ref3 = np.asarray(jpi.slab_refine_pallas(
        *(jnp.asarray(a) for a in jdirect), jnp.asarray(cases.feats[:, :4]),
        jnp.asarray(cases.sband), jnp.asarray(cases.srow0), n_phi, n_rows=32, interpret=True,
        valid_mask=jnp.asarray(cases.vmask)))
    np.testing.assert_array_equal(got3[live], ref3[live])
    wp, pp = jdirect[0].shape[1:]
    ops = (*jdirect, *jpi.build_decode_arrays(cases.wspd, cases.phir, wp, pp),
           *jpi.build_crosspol_arrays(cases.crlut, cases.crw))
    ref2 = np.asarray(jpi.slab_refine_fused_pallas(
        *(jnp.asarray(a) for a in ops), jnp.asarray(cases.feats), jnp.asarray(cases.sband),
        jnp.asarray(cases.srow0), n_phi, n_rows=32, has_cr=True, interpret=True,
        valid_mask=jnp.asarray(cases.vmask)))
    got2 = K.slab_refine_fused(*cases.k2_args("cpu"), n_rows=32, index=cases.index("cpu")).numpy()
    got2 = got2.reshape(3, -1, K.SLAB_BLOCK).transpose(1, 0, 2)  # the reference's rows per block
    np.testing.assert_array_equal(got2[live], ref2[live][:, :3])


@pytest.mark.parametrize("n_rows", [32, 40, 48, 64])
def test_tie_sets_fit_the_slab_and_straddle_its_last_chunk(n_rows):
    sets = tie_sets(181, n_rows)
    cells = [c for s in sets for c in s]
    assert len(set(cells)) == len(cells)  # disjoint
    assert all(0 <= r < n_rows for r, _ in cells)
    last_chunk = (n_rows - 1) // 8
    assert any(r // 8 == last_chunk for r, _ in cells) and (n_rows - 1, 180) in cells
    if n_rows == K.SLAB_ROWS:  # the 48-row cases are the ones earlier kernels were held to
        assert sets[4] == [(17, 12), (41, 12)] and sets[8] == [(31, 179), (31, 180)]
    with pytest.raises(ValueError, match="multiple of 8"):
        tie_sets(181, 36)


def test_plain_slab_rows_argument_checked():
    """``n_rows`` reaches the plain versions (the default stays 48) and the
    wrappers check it on the card; on the CPU the slab start must still fit."""
    cases = seam_cases(n_phi=37)
    lut, u, v = cases.lut, cases.u, cases.v
    cases.feats[0, :4] = lut[0, 40, 3], u[40, 3] * 0.5, v[40, 3] * 0.5, 10.0  # cost 0 at row 40
    assert cases.sband[0] == 0 and cases.srow0[0] == 0
    index = cases.index("cpu")
    default = K.slab_refine(*cases.k3_args("cpu"), index=index).numpy()
    np.testing.assert_array_equal(default, K.slab_refine(*cases.k3_args("cpu"), n_rows=48,
                                                         index=index).numpy())
    assert default[0] == 40 * 37 + 3  # inside 48 rows, outside 32
    assert K.slab_refine(*cases.k3_args("cpu"), n_rows=32, index=index).numpy()[0] < 32 * 37
    assert K.k1_staged_fits(64, 46) and not K.k1_staged_fits(499, 181)


# ------------------------------------------------------------ the closure cache

def test_cache_key_includes_mode_and_sweep_knobs():
    """A mutated knob is never served a closure built under the old value
    (tests/test_pallas_inversion.py:379's counterpart); the modes key apart."""
    t = inv.prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, inc_step=1.0,
                           wspd_step=1.0, phi_step=10.0)
    fn1 = inv._get_invert_fn(t, 256, "fused", "cpu")
    assert inv._get_invert_fn(t, 256, "fused_exact", "cpu") is not fn1
    base = (inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN)
    seen = {fn1}
    try:
        for knobs in ((1.6, 4.0, 16), (1.6, 8.0, 16), (1.6, 8.0, 8)):
            inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN = knobs
            fn = inv._get_invert_fn(t, 256, "fused", "cpu")
            assert fn not in seen
            seen.add(fn)
    finally:
        inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN = base
    assert inv._get_invert_fn(t, 256, "fused", "cpu") is fn1  # restored knobs: the old entry
    try:
        inv._COARSE_MARGIN = 12
        with pytest.raises(ValueError, match="multiple of 8"):
            inv._make_fused_invert_fn(t, "cpu")
    finally:
        inv._COARSE_MARGIN = base[2]


def test_sweep_margin_script_on_the_cpu():
    """The margin sweep's script end to end at a small size: the reference is
    ``fused_exact``; the default configuration flips nothing there."""
    from xsarsea_tpu_torch.scripts import sweep_margin

    res = sweep_margin.main(n=256, device="cpu", configs=[(0.8, 4.0, 16), (3.2, 8.0, 8)],
                            reps=1, table_kwargs=dict(inc_step=2.0, wspd_step=0.4,
                                                      phi_step=4.0), log=lambda line: None)
    rows = res["rows"]
    assert res["reference_mpx_s"] > 0
    assert [r["config"] for r in rows] == [(0.8, 4.0, 16), (3.2, 8.0, 8)]
    assert rows[0]["flips_co"] == 0 and rows[0]["flips_dual"] == 0
    assert all(r["mpx_s"] > 0 for r in rows)
    assert (inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN) == (0.8, 4.0, 16)
