"""The port's inversion against the JAX package, on the CPU.

* exact path, float64, tables from ``InversionTables.from_arrays`` on the
  JAX tables' arrays: raw winners bit-equal to JAX ``mode="exact"``;
  final winds equal up to the phi = +-180 deg tie (tests/_parity.py) and a
  1e-13 relative slack, where only torch's and XLA's atan2/sin/cos could
  differ;
* fused path (plain kernel versions, float32) against the port's exact
  path (equal up to the tie) and against JAX ``mode="pallas_interpret"``
  (equal up to the tie and 2**-22 relative: XLA's and torch's float32
  sin/cos of the same winner may differ by an ulp; a different winner
  would differ by a whole LUT step);
* ``invert_from_model`` end to end against JAX ``mode="exact"``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xsarsea_tpu.dimarray import DimArray as JDimArray
from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.windspeed import inversion as inv
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_from_model, \
    invert_pixels, prepare_tables

from _parity import assert_equal_modulo_pi_ties

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))

SMALL = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
F64_TRIG = 1e-13
F32_TRIG = 2.0 ** -22


def assert_parity(got, ref, rel=0.0):
    """assert_equal_modulo_pi_ties with a relative slack for trig ulps."""
    if rel == 0.0:
        return assert_equal_modulo_pi_ties(got, ref)
    got, ref = np.asarray(got), np.asarray(ref)
    mask = ~np.isnan(np.abs(ref))
    np.testing.assert_array_equal(np.isnan(np.abs(got)), ~mask)
    g, r = got[mask], ref[mask]
    tie = (np.abs(g - np.conj(r)) <= rel * np.abs(r)) & (np.abs(r.imag) < 1e-4)
    np.testing.assert_allclose(np.where(tie, np.conj(g), g), r, rtol=rel, atol=0)


def _jax_tables(dtype, co=True, cr=True, luts=None):
    lut_co, lut_cr = luts or (jax_model("gmf_cmod5n").to_lut(units="dB", **SMALL),
                              jax_model("gmf_s1_v2").to_lut(units="dB", **SMALL))
    return jinv.InversionTables(lut_co if co else None, lut_cr if cr else None, dtype=dtype), \
        lut_co, lut_cr


def _port_tables(jt, lut_co, lut_cr, dtype):
    """The port's tables on the JAX tables' LUT bits (coordinates at full
    precision, so the wind-component grids are rebuilt bit for bit)."""
    kw = {}
    if jt.has_co:
        c = lut_co.coords
        kw.update(co_lut=jt.co_lut, co_inc=c["incidence"], co_wspd=c["wspd"], co_phi=c["phi"])
    if jt.has_cr:
        c = lut_cr.coords
        kw.update(cr_lut=jt.cr_lut, cr_inc=c["incidence"], cr_wspd=c["wspd"])
    tt = InversionTables.from_arrays(**kw, dtype=dtype)
    for f in (jt._CO_FIELDS if jt.has_co else ()) + (jt._CR_FIELDS if jt.has_cr else ()):
        np.testing.assert_array_equal(getattr(tt, f), np.asarray(getattr(jt, f)), err_msg=f)
    return tt


def _gmf_scene(seed, n=300, inc_hi=60.0, dsig_cr=None, nan_pixels=True):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(17.0, inc_hi, n)
    speed = rng.uniform(1.0, 28.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0_co = np.array(jax_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc)),
                                             broadcast=True))
    s0_cr = np.array(jax_model("gmf_s1_v2")(inc, speed, broadcast=True))
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    dsig = rng.uniform(0.1, 1.0, n) if dsig_cr is None else np.full(n, dsig_cr)
    if nan_pixels:
        inc[0] = np.nan
        s0_co[1] = np.nan
        anc[2] = np.nan
        s0_cr[3] = np.nan
    return inc, s0_co, s0_cr, dsig, anc


def _db(x):
    return 10 * np.log10(x + 1e-15)


def _tied_luts():
    """LUTs with duplicated wspd rows and phi columns -> exact cost ties
    (tests/test_tie_rules.py)."""
    rng = np.random.default_rng(3)
    inc = np.linspace(18.0, 46.0, 8)
    wspd = np.round(np.linspace(1.0, 30.0, 24), 3)
    phi = np.linspace(0.0, 180.0, 13)
    co = rng.uniform(-30.0, -5.0, (8, 24, 13))
    co[:, 7, :] = co[:, 6, :]
    co[:, 15, :] = co[:, 14, :]
    co[:, :, 5] = co[:, :, 4]
    cr = rng.uniform(-40.0, -20.0, (8, 24))
    cr[:, 11] = cr[:, 10]
    lut_co = JDimArray(co, dims=("incidence", "wspd", "phi"),
                       coords={"incidence": inc, "wspd": wspd, "phi": phi}, attrs={"units": "dB"})
    lut_cr = JDimArray(cr, dims=("incidence", "wspd"), coords={"incidence": inc, "wspd": wspd},
                       attrs={"units": "dB"})
    return lut_co, lut_cr


def _tied_scene(seed, lut_co, lut_cr, n=500):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(17.0, 47.0, n)
    s0_co = np.asarray(lut_co.data).reshape(-1)[rng.integers(0, lut_co.size, n)]
    s0_cr = np.asarray(lut_cr.data).reshape(-1)[rng.integers(0, lut_cr.size, n)]
    anc = np.where(rng.random(n) < 0.3, 0.0 + 0.0j,
                   rng.uniform(1, 20, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n)))
    return inc, _db(10 ** (s0_co / 10.0)), _db(10 ** (s0_cr / 10.0)), np.full(n, 0.2), anc


def _assert_flips_are_ties(got, ref, tables, args, rtol):
    """Outputs agree except on pixels whose two winners have the same cost
    up to ``rtol`` (exact-form cost in float64 on the tables' values): on
    the tie-engineered LUTs, duplicated LUT columns give costs equal in real
    arithmetic, and a one-ulp difference (XLA's fused multiply-adds, or the
    fused path's multiply by 1/dsig) decides between them."""
    (co_g, du_g), (co_r, du_r) = got, ref

    def differ(a, b):
        return ~((a == b) | (np.isnan(a) & np.isnan(b)))

    flips = differ(co_g, co_r)
    assert not (differ(du_g, du_r) & ~flips).any()  # dual follows the copol winner
    assert flips.mean() < 0.02
    inc, s0, _, _, anc = args
    lut, u, v, w, p = (np.asarray(getattr(tables, f), np.float64)
                       for f in ("co_lut", "co_u", "co_v", "co_wspd", "co_phir"))
    ginc = np.asarray(tables.co_inc, np.float64)
    for i in np.nonzero(flips)[0]:
        ii = np.argmin(np.abs(ginc - inc[i]))

        def cost(z):
            iw, ip = np.argmin(np.abs(w - abs(z))), np.argmin(np.abs(p - abs(np.angle(z))))
            return (((u[iw, ip] - anc[i].real) / 2) ** 2
                    + ((v[iw, ip] - abs(anc[i].imag)) / 2) ** 2
                    + ((lut[ii, iw, ip] - s0[i]) / 0.1) ** 2)

        j_got, j_ref = cost(co_g[i]), cost(co_r[i])
        assert abs(j_got - j_ref) <= rtol * max(1.0, j_ref), (i, co_g[i], co_r[i], j_got, j_ref)


# ------------------------------------------------------------ (e) exact path

def test_argmin_nan_rule_matches_jnp():
    rows = np.array([[3.0, np.nan, 1.0, np.nan], [2.0, 1.0, 1.0, 0.5], [np.nan] * 4,
                     [np.inf, np.inf, np.inf, np.inf], [1.0, 1.0, np.nan, 0.0],
                     [-np.inf, 5.0, -np.inf, np.nan]])
    ref = np.asarray(jnp.argmin(jnp.asarray(rows), axis=1))
    np.testing.assert_array_equal(ref, np.argmin(rows, axis=1))
    np.testing.assert_array_equal(torch.argmin(torch.as_tensor(rows), 1).numpy(), ref)
    np.testing.assert_array_equal(inv._first_argmin(torch.as_tensor(rows), -1).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_raw_winners_bit_equal_to_jax(seed):
    jt, lut_co, lut_cr = _jax_tables(jnp.float64)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float64)
    inc, s0_co, _, _, anc = _gmf_scene(seed, nan_pixels=False)
    s0 = _db(s0_co)
    jdev = jt.to_device()
    dsig = jnp.asarray(0.1, jnp.float64)

    def one(i, s, a, z):
        return jinv._copol_solution(jdev, jinv._nearest_index(jdev.co_inc, i), s, a, z, dsig)

    jw, jphi = (np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(inc), jnp.asarray(s0), jnp.asarray(anc.real), jnp.asarray(anc.imag)))
    t = tt.to("cpu")
    ti = torch.as_tensor
    tw, tphi = inv._copol_solution(t, inv._nearest_index(t.co_inc, ti(inc)), ti(s0),
                                   ti(anc.real), ti(anc.imag), ti(0.1, dtype=torch.float64))
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(np.abs(tphi.numpy()), np.abs(jphi))
    # the sign comes from the same atan2/wrap sequence
    assert (np.sign(tphi.numpy()) != np.sign(jphi)).sum() <= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_winds_match_jax_f64(seed):
    jt, lut_co, lut_cr = _jax_tables(jnp.float64)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float64)
    inc, s0_co, s0_cr, dsig, anc = _gmf_scene(seed)
    args = (inc, _db(s0_co), _db(s0_cr), dsig, anc)
    ref = jinv.invert_pixels(jt, *args, mode="exact")
    got = invert_pixels(tt, *args, mode="exact", device="cpu", chunk_size=64)
    for g, r in zip(got, ref):
        assert g.dtype == np.complex128
        assert_parity(g, r, F64_TRIG)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_tied_luts_match_jax_f64(seed):
    lut_co, lut_cr = _tied_luts()
    jt = jinv.InversionTables(lut_co, lut_cr, dtype=jnp.float64)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float64)
    args = _tied_scene(seed, lut_co, lut_cr)
    ref = jinv.invert_pixels(jt, *args, mode="exact")
    got = invert_pixels(tt, *args, mode="exact", device="cpu")
    _assert_flips_are_ties(got, ref, tt, args, rtol=1e-12)


@pytest.mark.parametrize("co,cr", [(True, False), (False, True)])
def test_exact_monopol_tables_match_jax(co, cr):
    jt, lut_co, lut_cr = _jax_tables(jnp.float64, co=co, cr=cr)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float64)
    inc, s0_co, s0_cr, dsig, anc = _gmf_scene(4)
    nanv = np.full(inc.shape, np.nan)
    args = (inc, _db(s0_co) if co else nanv, _db(s0_cr) if cr else nanv, dsig,
            anc if co else nanv)
    ref = jinv.invert_pixels(jt, *args, mode="exact")
    got = invert_pixels(tt, *args, mode="exact", device="cpu")
    for g, r in zip(got, ref):
        assert_parity(g, r, F64_TRIG)


# ------------------------------------------------------------ (f) fused path

def test_fused_matches_exact_and_jax_pallas_f32():
    """The scene of tests/test_pallas_inversion.py:340-376."""
    jt, lut_co, lut_cr = _jax_tables(jnp.float32)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    inc, s0_co, s0_cr, _, anc = _gmf_scene(11, inc_hi=50.0, dsig_cr=0.3, nan_pixels=False)
    args = (inc, _db(s0_co), _db(s0_cr), np.full(inc.shape, 0.3), anc)
    fused = invert_pixels(tt, *args, mode="fused", device="cpu")
    exact = invert_pixels(tt, *args, mode="exact", device="cpu")
    jp = jinv.invert_pixels(jt, *args, mode="pallas_interpret")
    for f, e, j in zip(fused, exact, jp):
        assert f.dtype == np.complex64
        assert_equal_modulo_pi_ties(f, e)
        assert_parity(f, j, F32_TRIG)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_close_to_exact_random_dsig(seed):
    """Random dsig_cr (tests/test_pallas_inversion.py:83-123 contract): the
    fused cost multiplies by 1/dsig where exact divides, which can flip
    near-tie argmins on rare pixels; speeds must agree tightly."""
    jt, lut_co, lut_cr = _jax_tables(jnp.float32)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    inc, s0_co, s0_cr, dsig, anc = _gmf_scene(seed)
    args = (inc, _db(s0_co), _db(s0_cr), dsig, anc)
    co_e, dual_e = invert_pixels(tt, *args, mode="exact", device="cpu")
    co_p, dual_p = invert_pixels(tt, *args, mode="fused", device="cpu")
    np.testing.assert_array_equal(np.isnan(np.abs(co_e)), np.isnan(np.abs(co_p)))
    np.testing.assert_array_equal(np.isnan(np.abs(dual_e)), np.isnan(np.abs(dual_p)))
    m = ~np.isnan(np.abs(co_e))
    sp = np.abs(np.abs(co_e[m]) - np.abs(co_p[m]))
    assert np.mean(sp > 1e-6) < 0.02 and np.sqrt(np.mean(sp ** 2)) < 1e-3
    md = ~np.isnan(np.abs(dual_e))
    assert np.sqrt(np.mean((np.abs(dual_e[md]) - np.abs(dual_p[md])) ** 2)) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_tied_luts_match_exact(seed):
    lut_co, lut_cr = _tied_luts()
    jt = jinv.InversionTables(lut_co, lut_cr, dtype=jnp.float32)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    args = _tied_scene(seed, lut_co, lut_cr)
    _assert_flips_are_ties(invert_pixels(tt, *args, mode="fused", device="cpu"),
                           invert_pixels(tt, *args, mode="exact", device="cpu"), tt, args,
                           rtol=1e-6)


def test_fused_copol_only_and_streaming_pieces():
    jt, lut_co, lut_cr = _jax_tables(jnp.float32, cr=False)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    inc, s0_co, _, dsig, anc = _gmf_scene(7)
    nanv = np.full(inc.shape, np.nan)
    args = (inc, _db(s0_co), nanv, nanv, anc)
    whole = invert_pixels(tt, *args, mode="fused", device="cpu")
    pieces = invert_pixels(tt, *args, mode="fused", device="cpu", piece_size=64)
    on_dev = invert_pixels(tt, *(torch.as_tensor(a) for a in args), mode="fused",
                           device="cpu", device_output=True, piece_size=64)
    assert np.isnan(np.abs(whole[1])).all()
    assert_equal_modulo_pi_ties(whole[0], invert_pixels(tt, *args, mode="exact",
                                                        device="cpu")[0])
    for w, p, d in zip(whole, pieces, on_dev):
        np.testing.assert_array_equal(w, p)
        np.testing.assert_array_equal(w, d.numpy())


def test_mode_resolution_and_errors():
    jt, lut_co, lut_cr = _jax_tables(jnp.float32)
    tt = _port_tables(jt, lut_co, lut_cr, torch.float32)
    assert inv._resolve_mode("auto", tt, "cpu") == "exact"
    assert inv._resolve_mode("auto", tt, "cuda") == "fused"
    with pytest.raises(ValueError, match="mode"):
        inv._resolve_mode("pallas", tt, "cpu")
    co_only = InversionTables.from_arrays(
        tt.co_lut, lut_co.coords["incidence"], lut_co.coords["wspd"], lut_co.coords["phi"])
    cr_only = InversionTables.from_arrays(cr_lut=tt.cr_lut, cr_inc=lut_cr.coords["incidence"],
                                          cr_wspd=lut_cr.coords["wspd"])
    assert inv._resolve_mode("auto", cr_only, "cuda") == "exact"
    with pytest.raises(ValueError, match="copol"):
        inv._make_fused_invert_fn(cr_only, "cpu")
    # a crosspol LUT on another incidence axis takes the unfused tail (K3/K4,
    # tests/test_torch_unfused.py) in the fused and auto modes alike
    shifted = InversionTables.from_arrays(
        tt.co_lut, lut_co.coords["incidence"], lut_co.coords["wspd"], lut_co.coords["phi"],
        tt.cr_lut, lut_cr.coords["incidence"] + 0.25, lut_cr.coords["wspd"])
    assert inv._resolve_mode("auto", shifted, "cuda") == "fused"
    assert callable(inv._make_fused_invert_fn(shifted, "cpu"))
    assert co_only.has_co and not co_only.has_cr
    with pytest.raises(ValueError, match="3-D"):
        InversionTables(DimArray(tt.cr_lut, dims=("incidence", "wspd")), None)


# ------------------------------------------------------ (g) invert_from_model

def test_invert_from_model_dualpol_matches_jax_exact():
    inc, s0_co, s0_cr, _, anc = _gmf_scene(21)
    ref_co, ref_dual = jinv.invert_from_model(
        inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=0.1, model=("gmf_cmod5n", "gmf_s1_v2"),
        mode="exact", device_db=False, **SMALL)
    co, dual = invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=0.1,
                                 model=("gmf_cmod5n", "gmf_s1_v2"), device="cpu",
                                 device_db=False, **SMALL)
    assert co.dtype == np.complex128 and co.shape == inc.shape
    assert_parity(co, ref_co, F64_TRIG)
    assert_parity(dual, ref_dual, F64_TRIG)


def test_invert_from_model_monopol_and_dimarray():
    inc, s0_co, s0_cr, _, anc = _gmf_scene(22, nan_pixels=False)
    with pytest.warns(UserWarning, match="pol"):
        ref = jinv.invert_from_model(inc, s0_co, ancillary_wind=anc, model="cmod5n",
                                     mode="exact", **SMALL)
    da = DimArray(s0_co.reshape(15, 20), dims=("line", "sample"), coords={"pol": "VV"})
    got = invert_from_model(inc.reshape(15, 20), da, ancillary_wind=anc.reshape(15, 20),
                            model="cmod5n", device="cpu", **SMALL)
    assert isinstance(got, DimArray) and got.attrs["model"] == "gmf_cmod5n"
    assert_parity(got.values.reshape(-1), ref, F64_TRIG)
    with pytest.warns(UserWarning, match="ancillary"):
        speed = invert_from_model(inc, s0_cr, ancillary_wind=anc, model="gmf_s1_v2",
                                  device="cpu", **SMALL)
    with pytest.warns(UserWarning):
        ref_speed = jinv.invert_from_model(inc, s0_cr, ancillary_wind=anc, model="gmf_s1_v2",
                                           mode="exact", **SMALL)
    np.testing.assert_allclose(speed, ref_speed, rtol=F64_TRIG)
    with pytest.raises(ValueError, match="pol"):
        invert_from_model(inc, DimArray(s0_co, dims=("x",), coords={"pol": "VH"}),
                          ancillary_wind=anc, model="cmod5n", device="cpu", **SMALL)
    with pytest.raises(ValueError, match="ancillary"):
        invert_from_model(inc, s0_co, ancillary_wind=np.full(inc.shape, np.nan),
                          model="cmod5n", device="cpu", **SMALL)


def test_invert_from_model_vector_incidence_and_device_db():
    """A (nx,) incidence vector gives the bits of the full incidence field,
    and the float32 fused path with sigma0 converted on the device matches
    the exact path given the same device conversion."""
    rng = np.random.default_rng(23)
    ny, nx = 12, 25
    inc_vec = np.linspace(20.0, 45.0, nx)
    speed = rng.uniform(2.0, 25.0, (ny, nx))
    direc = rng.uniform(-np.pi, np.pi, (ny, nx))
    inc = np.broadcast_to(inc_vec, (ny, nx))
    s0_co = np.asarray(jax_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc)),
                                               broadcast=True))
    s0_cr = np.asarray(jax_model("gmf_s1_v2")(inc, speed, broadcast=True))
    anc = speed * np.exp(1j * direc)
    kw = dict(ancillary_wind=anc, model=("gmf_cmod5n", "gmf_s1_v2"), device="cpu",
              dtype=torch.float32, **SMALL)
    full = invert_from_model(np.ascontiguousarray(inc), s0_co, s0_cr, mode="fused", **kw)
    vec = invert_from_model(inc_vec, s0_co, s0_cr, mode="fused", **kw)
    line = invert_from_model(inc_vec[None, :].T.repeat(ny, 1)[:ny, :1] * 0 + inc[:, :1],
                             s0_co, s0_cr, mode="fused", **kw)
    exact = invert_from_model(inc_vec, s0_co, s0_cr, mode="exact", device_db=True, **kw)
    for f, v, e in zip(full, vec, exact):
        np.testing.assert_array_equal(f, v)
        assert_equal_modulo_pi_ties(v.reshape(-1), e.reshape(-1))
    assert line[0].shape == (ny, nx)
    with pytest.raises(ValueError, match="broadcastable"):
        invert_from_model(inc_vec[:-1], s0_co, s0_cr, **kw)


def test_prepare_tables_cached_and_f64_default_on_cpu():
    a = prepare_tables("cmod5n", "s1_v2", dtype=torch.float64, **SMALL)
    b = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float64, **SMALL)
    assert a is b and a.co_lut.dtype == np.float64 and a.phi_180
    assert a.to("cpu") is a.to("cpu") and isinstance(a.to("cpu").co_lut, torch.Tensor)


# --------------------------------------------------------- (h) import hygiene

def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    without pulling in JAX, the JAX package or its optional dependencies."""
    code = ("import importlib, pkgutil, sys, xsarsea_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(xsarsea_tpu_torch.__path__, "
            "'xsarsea_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'xsarsea_tpu', 'pandas', 'yaml', 'xarray', 'dask', 'h5py', "
            "'ml_dtypes', 'matplotlib', 'holoviews', 'fsspec'))\n"
            "print(bad); print(*names); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.splitlines()[1].split())
    assert {"xsarsea_tpu_torch.windspeed.inversion", "xsarsea_tpu_torch.ops.experiment_kernels",
            "xsarsea_tpu_torch.scripts.bench_slab_forms",
            "xsarsea_tpu_torch.scripts.bench_kernel_variants", "xsarsea_tpu_torch.dimarray",
            "xsarsea_tpu_torch.interop", "xsarsea_tpu_torch.directions",
            "xsarsea_tpu_torch.detrend", "xsarsea_tpu_torch.windspeed.dsig",
            "xsarsea_tpu_torch.models.gmf", "xsarsea_tpu_torch.utils",
            "xsarsea_tpu_torch.utils.staging", "xsarsea_tpu_torch.ops.conv2d",
            "xsarsea_tpu_torch.gradients", "xsarsea_tpu_torch.cli",
            "xsarsea_tpu_torch.scripts.demo_full_scene", "xsarsea_tpu_torch.scripts.bench_stages",
            "xsarsea_tpu_torch.scripts.bench_streaks_stages",
            "xsarsea_tpu_torch.scripts.bench_gather_sizes",
            "xsarsea_tpu_torch.scripts.bench_scaling", "xsarsea_tpu_torch.bench"} | {
        f"xsarsea_tpu_torch.examples.{name}" for name in (
            "create_hh_lut", "detrend_roughness", "gmfs_and_luts", "multichip_batch",
            "out_of_core_scene", "streaks_direction", "windspeed_retrieval")} <= walked
