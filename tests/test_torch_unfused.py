"""The inversion's unfused tail (crosspol LUT on its own incidence axis: K1,
K3, decode, K4) against the JAX package, on the CPU, on three table pairs:

1. ``gmf_cmod5n`` at ``inc_step=0.5`` with ``gmf_s1_v2`` at ``inc_step=0.7``
   (tests/test_pallas_inversion.py:197-224);
2. the sarwing pickle fixtures (copol 1 deg, crosspol 0.5 deg);
3. the KNMI CMOD7 fixture at 0.5 deg / 0.5 m/s / 5 deg with the sarwing
   crosspol LUT.

* port ``mode="fused"`` (plain kernel versions, float32) against JAX
  ``mode="pallas_interpret"``: the same winners, NaN masks identical,
  outputs equal up to the phi = +-180 deg tie and 2**-22 relative (XLA's
  and torch's float32 sin/cos of the same winner differ by an ulp on a few
  pixels; another winner would differ by a whole LUT step, >= 1e-3);
* port ``mode="fused"`` against the port's own ``mode="exact"``: equal up
  to the tie (the same trig);
* port ``mode="exact"`` float64 against JAX ``mode="exact"``: equal up to
  the tie and 1e-13 relative (trig only).
"""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xsarsea_tpu.models as J
from xsarsea_tpu.windspeed import inversion as jinv
import xsarsea_tpu_torch.models as P
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.windspeed import inversion as inv
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_from_model, \
    invert_pixels

from _parity import assert_equal_modulo_pi_ties
from test_torch_inversion import F32_TRIG, F64_TRIG, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SARWING = ("sarwing_lut__fix_co_2_1", "sarwing_lut__fix_cr_2_1")
PAIRS = ["cmod5n_inc0.5__s1v2_inc0.7", "sarwing", "cmod7__sarwing_cr"]


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    """The JAX LUTs (dB) of each pair, with the LUT-file models registered
    in both packages."""
    d = tmp_path_factory.mktemp("knmi") / "cmod7"
    d.mkdir()
    with gzip.open(os.path.join(DATA, "knmi_cmod7", "cmod7",
                                "gmf_cmod7_vv.dat_little_endian.gz"), "rb") as f_in, \
            open(d / "gmf_cmod7_vv.dat_little_endian", "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    for M in (J, P):
        M.register_cmod7(str(d))
        M.register_pickle_luts(os.path.join(DATA, "sarwing_luts"))
    small = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)

    def db(name, **kw):
        return J.get_model(name).to_lut(units="dB", **kw)

    return {
        PAIRS[0]: (db("gmf_cmod5n", **small), db("gmf_s1_v2", **{**small, "inc_step": 0.7})),
        PAIRS[1]: (db(SARWING[0]), db(SARWING[1])),
        PAIRS[2]: (db("gmf_cmod7", **small), db(SARWING[1])),
    }


def _tables(lut_co, lut_cr, jdtype, tdtype):
    jt = jinv.InversionTables(lut_co, lut_cr, dtype=jdtype)
    c, r = lut_co.coords, lut_cr.coords
    tt = InversionTables.from_arrays(jt.co_lut, c["incidence"], c["wspd"], c["phi"], jt.cr_lut,
                                     r["incidence"], r["wspd"], dtype=tdtype)
    for f in jt._CO_FIELDS + jt._CR_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f), np.asarray(getattr(jt, f)), err_msg=f)
    assert not np.array_equal(tt.co_inc, tt.cr_inc)  # the unfused tail
    return jt, tt


def _scene(seed, lut_co, n=300):
    """Off-GMF sigma0 over the copol LUT's range, with a NaN pixel of every
    kind (tests/test_pallas_inversion.py:101-105) plus a NaN dsig."""
    rng = np.random.default_rng(seed)
    inc_grid = np.asarray(lut_co.coords["incidence"])
    inc = rng.uniform(inc_grid[0] + 0.5, inc_grid[-1], n)
    s0_co = rng.uniform(-30.0, 0.0, n)
    s0_cr = rng.uniform(-40.0, -15.0, n)
    anc = rng.uniform(1, 25, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    dsig_cr = rng.uniform(0.1, 1.0, n)
    inc[0] = np.nan
    s0_co[1] = np.nan
    anc[2] = np.nan
    s0_cr[3] = np.nan
    dsig_cr[4] = np.nan
    return inc, s0_co, s0_cr, dsig_cr, anc


@pytest.mark.parametrize("pair", PAIRS)
def test_unfused_fused_matches_jax_pallas(luts, pair):
    lut_co, lut_cr = luts[pair]
    jt, tt = _tables(lut_co, lut_cr, jnp.float32, torch.float32)
    args = _scene(PAIRS.index(pair), lut_co)
    K.reset_launch_counts()
    fused = invert_pixels(tt, *args, mode="fused", device="cpu")
    exact = invert_pixels(tt, *args, mode="exact", device="cpu")
    ref = jinv.invert_pixels(jt, *args, mode="pallas_interpret")
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)  # plain versions on the CPU
    for f, e, r in zip(fused, exact, ref):
        assert f.dtype == np.complex64
        assert_equal_modulo_pi_ties(f, e)
        assert_parity(f, r, F32_TRIG)
    assert np.isnan(fused[0][[0, 1, 2]]).all() and np.isnan(fused[1][[0, 2, 3, 4]]).all()
    assert not np.isnan(fused[1][1])  # no copol: the crosspol speed still solves


@pytest.mark.parametrize("pair", PAIRS)
def test_unfused_exact_f64_matches_jax(luts, pair):
    lut_co, lut_cr = luts[pair]
    jt, tt = _tables(lut_co, lut_cr, jnp.float64, torch.float64)
    args = _scene(10 + PAIRS.index(pair), lut_co)
    got = invert_pixels(tt, *args, mode="exact", device="cpu", chunk_size=64)
    ref = jinv.invert_pixels(jt, *args, mode="exact")
    for g, r in zip(got, ref):
        assert g.dtype == np.complex128
        assert_parity(g, r, F64_TRIG)


def test_unfused_tail_routes_through_k3_k4(luts, monkeypatch):
    """The unfused tail calls K1, K3 and K4 and never K2; equal axes call
    K1 and K2 only."""
    called = []
    for name in K.KERNELS:
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _f=fn, **k: called.append(_n) or
                            _f(*a, **k))
    lut_co, lut_cr = luts[PAIRS[0]]
    _, tt = _tables(lut_co, lut_cr, jnp.float32, torch.float32)
    args = _scene(5, lut_co, n=64)
    invert_pixels(tt, *args, mode="fused", device="cpu")
    assert sorted(called) == ["crosspol_argmin", "group_argmin", "slab_refine"]
    called.clear()
    same = InversionTables.from_arrays(tt.co_lut, tt.co_inc, lut_co.coords["wspd"],
                                       lut_co.coords["phi"], tt.co_lut[:, :, 0],
                                       tt.co_inc, lut_co.coords["wspd"])
    invert_pixels(same, *args, mode="fused", device="cpu")
    assert sorted(called) == ["group_argmin", "slab_refine_fused"]
    assert inv._resolve_mode("auto", tt, "cuda") == "fused"


def test_invert_from_model_by_name_sarwing_pair(luts):
    """Dual-pol ``invert_from_model`` with the sarwing models by name."""
    inc, s0_co, s0_cr, _, anc = _scene(21, luts["sarwing"][0])
    s0_co, s0_cr = 10 ** (s0_co / 10), 10 ** (s0_cr / 10)
    kw = dict(ancillary_wind=anc, dsig_cr=0.3, model=SARWING, device_db=False)
    ref_co, ref_dual = jinv.invert_from_model(inc, s0_co, s0_cr, mode="exact", **kw)
    co, dual = invert_from_model(inc, s0_co, s0_cr, device="cpu", **kw)
    assert co.dtype == np.complex128 and co.shape == inc.shape
    assert_parity(co, ref_co, F64_TRIG)
    assert_parity(dual, ref_dual, F64_TRIG)
    jp = jinv.invert_from_model(inc, s0_co, s0_cr, mode="pallas_interpret", dtype=jnp.float32,
                                **kw)
    fused = invert_from_model(inc, s0_co, s0_cr, device="cpu", mode="fused",
                              dtype=torch.float32, **kw)
    for f, r in zip(fused, jp):
        assert f.dtype == np.complex64
        assert_parity(f, r, F32_TRIG)
