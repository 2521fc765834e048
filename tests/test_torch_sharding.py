"""The port's ``parallel`` package against the one-device port and the JAX
package (tests/test_sharding.py), on the CPU.

The port's mesh is ``["cpu"] * 8``, the JAX tests' eight host devices
(tests/conftest.py): one program, one host thread per distinct device, no
process group and no subprocess. Tables are float64 and carried across with
``InversionTables.from_arrays``, so the exact path is held bit for bit: the
sharded result against the port's one-device result, and against the JAX
sharded result up to the phi = +-180 deg tie and torch's and XLA's trig ulps
(tests/test_torch_inversion.py).
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu import parallel as jpar
from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu_torch import gradients as G
from xsarsea_tpu_torch import parallel as par
from xsarsea_tpu_torch.parallel import inversion as pinv
from xsarsea_tpu_torch.parallel.mesh import run_on_devices
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_pixels

from test_streaming import LazyRows
from test_torch_inversion import F32_TRIG, F64_TRIG, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

SMALL = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
CPU8 = ["cpu"] * 8


def make_pixels(n=700, seed=0):
    """tests/test_sharding.py's pixels (GMF sigma0, noisy ancillary, three
    NaN pixels)."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(19.0, 45.0, n)
    speed = rng.uniform(1.5, 25.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    co_fn = jax_model("gmf_cmod5n")._gmf_fn
    cr_fn = jax_model("gmf_s1_v2")._gmf_fn
    s0_co_db = 10 * np.log10(np.asarray(co_fn(inc, speed, np.abs(np.rad2deg(direc)))) + 1e-15)
    s0_cr_db = 10 * np.log10(np.asarray(cr_fn(inc, speed)) + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    dsig_cr = rng.uniform(0.1, 1.0, n)
    inc[0] = np.nan
    s0_co_db[1] = np.nan
    anc[2] = np.nan
    return inc, s0_co_db, s0_cr_db, dsig_cr, anc


def _pair(dtype, co=True, cr=True, co_lut=None):
    """JAX tables and the port's on the same arrays."""
    lut_co = jax_model("gmf_cmod5n").to_lut(units="dB", **SMALL)
    lut_cr = jax_model("gmf_s1_v2").to_lut(units="dB", **SMALL)
    if co_lut is not None:
        lut_co = lut_co.copy(data=co_lut)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jt = jinv.InversionTables(lut_co if co else None, lut_cr if cr else None, dtype=jdtype)
    kw = {}
    if co:
        c = lut_co.coords
        kw.update(co_lut=np.asarray(jt.co_lut), co_inc=c["incidence"], co_wspd=c["wspd"],
                  co_phi=c["phi"])
    if cr:
        c = lut_cr.coords
        kw.update(cr_lut=np.asarray(jt.cr_lut), cr_inc=c["incidence"], cr_wspd=c["wspd"])
    return jt, InversionTables.from_arrays(**kw, dtype=dtype)


@pytest.fixture(scope="module")
def f64():
    return _pair(torch.float64)


@pytest.fixture(scope="module")
def f32():
    return _pair(torch.float32)


def _scenes(shapes, seed0=0):
    scenes = []
    for seed, (h, w) in enumerate(shapes, start=seed0):
        inc, s0_co, s0_cr, dsig_cr, anc = (a.reshape(h, w) for a in make_pixels(h * w, seed))
        scenes.append(dict(inc=inc, sigma0_co_db=s0_co, sigma0_cr_db=s0_cr, dsig_cr=dsig_cr,
                           ancillary_wind=anc))
    return scenes


def _flat(scene):
    return [scene[k].reshape(-1) for k in ("inc", "sigma0_co_db", "sigma0_cr_db", "dsig_cr",
                                           "ancillary_wind")]


def _same(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------------------------- the mesh

def test_mesh_layout_and_identity():
    mesh = par.make_mesh(n_data=4, n_model=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh == par.make_mesh(4, 2, devices=CPU8) and hash(mesh) == hash(
        par.make_mesh(4, 2, devices=CPU8))
    assert mesh != par.make_mesh(2, 4, devices=CPU8)
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    assert par.make_mesh(devices=CPU8).shape == {"data": 8, "model": 1}


def test_make_mesh_too_few_devices_raises():
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        par.make_mesh(n_model=100, devices=CPU8)  # more model shards than devices
    with pytest.raises(ValueError, match="need 16 devices"):
        par.make_mesh(n_data=8, n_model=2, devices=CPU8)
    if not torch.cuda.is_available():  # the default devices are the CUDA ones
        with pytest.raises(ValueError, match="0 devices"):
            par.make_mesh()


def test_run_on_devices_one_thread_per_distinct_device():
    seen = {}
    lock = threading.Lock()

    def task(k):
        with lock:
            seen[k] = threading.current_thread()  # held: no reuse of a finished one
        return k * k

    devices = [torch.device("cpu"), torch.device("cpu", 0)] * 3
    assert run_on_devices([(d, lambda k=k: task(k)) for k, d in enumerate(devices)]) == \
        [k * k for k in range(6)]
    assert len({seen[k] for k in (0, 2, 4)}) == 1 and len({seen[k] for k in (1, 3, 5)}) == 1
    assert seen[0] != seen[1]
    main = threading.current_thread()  # one device: inline, on the caller's thread
    assert run_on_devices([("cpu", threading.current_thread)] * 2) == [main, main]


# ------------------------------------------------------------- exact, sharded

@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_exact_bit_equal_to_single_device_and_jax(f64, n_data, n_model):
    jt, tt = f64
    args = make_pixels()
    mesh = par.make_mesh(n_data, n_model, devices=CPU8)
    got = par.sharded_invert_pixels(tt, *args, mesh=mesh)
    _same(got, invert_pixels(tt, *args, mode="exact", device="cpu"))
    ref = jpar.sharded_invert_pixels(jt, *args, mesh=jpar.make_mesh(n_data, n_model))
    for g, r in zip(got, ref):
        assert g.dtype == np.complex128 and g.shape == (700,)
        assert_parity(g, r, F64_TRIG)


def test_sharded_crosspol_only(f64):
    """Tables without a copol grid (nothing to pad or split along phi)."""
    jt, tt = _pair(torch.float64, co=False)
    inc, _, s0_cr_db, dsig_cr, _ = make_pixels(n=300, seed=3)
    nanv = np.full_like(inc, np.nan)
    args = (inc, nanv, s0_cr_db, dsig_cr, nanv + 0j)
    mesh = par.make_mesh(4, 2, devices=CPU8)
    got = par.sharded_invert_pixels(tt, *args, mesh=mesh)
    _same(got, invert_pixels(tt, *args, mode="exact", device="cpu"))
    ref = jpar.sharded_invert_pixels(jt, *args, mesh=jpar.make_mesh(4, 2))
    for g, r in zip(got, ref):
        assert_parity(g, r, F64_TRIG)


def test_sharded_nan_minimum_pixel():
    """A NaN LUT cell makes a pixel's minimum NaN: the combine leaves the
    2**30 sentinel, which the reference decodes by clipping gathers (the last
    wspd row, phi column 2**30 % P). The port clamps the row explicitly, and
    its pixel equals the JAX sharded pixel; NaN-s0 pixels take the same route
    and stay masked."""
    lut = np.array(jax_model("gmf_cmod5n").to_lut(units="dB", **SMALL).data)
    inc, s0_co, s0_cr, dsig_cr, anc = make_pixels(n=64, seed=5)
    grid = np.asarray(jax_model("gmf_cmod5n").to_lut(units="dB", **SMALL).coords["incidence"])
    band = int(np.argmin(np.abs(grid - inc[10])))
    lut[band, 7, 3] = np.nan
    jt, tt = _pair(torch.float64, co_lut=lut)
    for n_data, n_model in ((4, 2), (8, 1)):
        mesh = par.make_mesh(n_data, n_model, devices=CPU8)
        got = par.sharded_invert_pixels(tt, inc, s0_co, s0_cr, dsig_cr, anc, mesh=mesh,
                                        chunk_size=32)
        ref = jpar.sharded_invert_pixels(jt, inc, s0_co, s0_cr, dsig_cr, anc,
                                         mesh=jpar.make_mesh(n_data, n_model), chunk_size=32)
        for g, r in zip(got, ref):
            assert_parity(g, r, F64_TRIG)
        wspd = np.asarray(tt.co_wspd)
        phir = pinv.pad_tables_for_model_axis(tt, n_model)[0].co_phir
        n_pad = phir.shape[0]
        assert abs(got[0][10]) == pytest.approx(wspd[-1], rel=1e-12)
        assert abs(np.angle(got[0][10])) == pytest.approx(abs(phir[2 ** 30 % n_pad]), abs=1e-12)
        assert np.isnan(got[0][1])  # NaN s0: the sentinel, masked


def test_sharded_exact_placement_cached(f64):
    """Repeated calls reuse one padded table set and one placed program."""
    _, tt = _pair(torch.float64)
    args = make_pixels(n=256, seed=4)
    mesh = par.make_mesh(4, 2, devices=CPU8)
    first = par.sharded_invert_pixels(tt, *args, mesh=mesh, chunk_size=64)
    cache = tt._invert_fn_cache
    keys = [k for k in cache if k[0] == "sharded_exact" and k[1] == mesh and k[2] == 64]
    assert len(keys) == 1
    program, padded = cache[keys[0]], cache[("padded_model", 2)]
    n_keys, n_slabs = len(cache), len(program._slabs)
    again = par.sharded_invert_pixels(tt, *args, mesh=par.make_mesh(4, 2, devices=CPU8),
                                      chunk_size=64)
    assert cache[keys[0]] is program and cache[("padded_model", 2)] is padded
    assert len(cache) == n_keys and len(program._slabs) == n_slabs == 2
    _same(again, first)


def test_pad_tables_for_model_axis_matches_jax(f64):
    jt, tt = f64
    for n_model in (1, 2, 4, 7):
        got, n_phi = pinv.pad_tables_for_model_axis(tt, n_model)
        ref, n_phi_ref = jpar.inversion.pad_tables_for_model_axis(jt, n_model)
        assert n_phi == n_phi_ref and got.co_phi.shape[0] % n_model == 0
        for f in ("co_lut", "co_u", "co_v", "co_phi", "co_phir"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)))
        assert (got is tt) == (got.co_phi.shape[0] == tt.co_phi.shape[0])
    assert got._invert_fn_cache == {} and got._device_copies == {}


# -------------------------------------------------------------- fused, sharded

@pytest.mark.parametrize("mode", ["fused", "fused_exact"])
def test_sharded_fused_bit_equal_to_single_device(f32, mode):
    """Data-parallel fused pipeline (plain kernels here) == one device, and
    == the JAX sharded Pallas path up to the tie and float32 trig ulps."""
    jt, tt = f32
    args = make_pixels(300, seed=3)
    got = par.sharded_invert_pixels(tt, *args, mesh=par.make_mesh(2, 1, devices=CPU8),
                                    mode=mode)
    _same(got, invert_pixels(tt, *args, mode=mode, device="cpu"))
    if mode == "fused":
        ref = jpar.sharded_invert_pixels(jt, *args, mesh=jpar.make_mesh(2, 1),
                                         mode="pallas_interpret")
        for g, r in zip(got, ref):
            assert g.dtype == np.complex64
            assert_parity(g, r, F32_TRIG)


def test_sharded_modes_resolve_and_refuse(f64):
    _, tt = f64
    args = make_pixels(64)
    mesh = par.make_mesh(4, 2, devices=CPU8)
    with pytest.raises(ValueError, match="model=1"):
        par.sharded_invert_pixels(tt, *args, mesh=mesh, mode="fused")
    with pytest.raises(ValueError, match="model=1"):
        par.sharded_invert_pixels(tt, *args, mesh=mesh, mode="fused_exact")
    with pytest.raises(ValueError, match="unknown inversion mode"):
        par.sharded_invert_pixels(tt, *args, mesh=par.make_mesh(2, 1, devices=CPU8),
                                  mode="palas_fast")
    assert pinv._resolve_sharded_mode("auto", tt, mesh) == "exact"  # a CPU mesh
    cuda_mesh = par.make_mesh(2, 1, devices=["cuda:0"] * 2)  # placing nothing
    assert pinv._resolve_sharded_mode("auto", tt, cuda_mesh) == "fused"
    assert pinv._resolve_sharded_mode("auto", tt, par.make_mesh(1, 2, devices=["cuda:0"] * 2)) \
        == "exact"
    # auto on a CPU mesh is the exact path, bit for bit
    _same(par.sharded_invert_pixels(tt, *args, mesh=mesh, mode="auto"),
          par.sharded_invert_pixels(tt, *args, mesh=mesh))


# ---------------------------------------------------------------- batch scenes

def test_invert_scenes_batch_matches_per_scene_and_jax(f64):
    jt, tt = f64
    scenes = _scenes([(20, 30), (16, 25), (7, 3)])
    outs = par.invert_scenes(tt, scenes, par.make_mesh(4, 2, devices=CPU8), chunk_size=64)
    ref = jpar.invert_scenes(jt, scenes, jpar.make_mesh(4, 2), chunk_size=64)
    assert len(outs) == 3
    for scene, (co, dual), (jco, jdual) in zip(scenes, outs, ref):
        assert co.shape == scene["inc"].shape and dual.shape == scene["inc"].shape
        _same((co.reshape(-1), dual.reshape(-1)),
              invert_pixels(tt, *_flat(scene), mode="exact", device="cpu"))
        assert_parity(co.reshape(-1), jco.reshape(-1), F64_TRIG)
        assert_parity(dual.reshape(-1), jdual.reshape(-1), F64_TRIG)


def test_invert_scenes_single_device_streamed(f64):
    """No mesh (and a one-device mesh): the one-device overlapped piece loop,
    bit-equal to the mesh path; pieces span scene boundaries."""
    _, tt = f64
    scenes = _scenes([(18, 22), (12, 31)])
    ref = par.invert_scenes(tt, scenes, par.make_mesh(8, 1, devices=CPU8), chunk_size=64,
                            mode="exact")
    for kw in (dict(mesh=None, device="cpu"), dict(mesh=par.make_mesh(1, 1, devices=["cpu"]))):
        got = par.invert_scenes(tt, scenes, chunk_size=64, mode="exact", piece_size=100, **kw)
        for (co_r, dual_r), (co_g, dual_g) in zip(ref, got):
            np.testing.assert_array_equal(co_g, co_r)
            np.testing.assert_array_equal(dual_g, dual_r)


def test_invert_scenes_streams_lazy_scenes(f64, tmp_path):
    """Lazy scenes (row generators, a memmap, a scalar dsig) go through the
    mesh in pieces with a padded tail and through the one-device loop, equal
    to the eager batch, and no request reads more than a piece and two
    partial rows."""
    _, tt = f64
    shapes = [(40, 50), (30, 44)]
    eager = _scenes(shapes)
    lazy = []
    for k, (scene, (h, w)) in enumerate(zip(eager, shapes)):
        scene["dsig_cr"] = np.full((h, w), 0.25)
        mm = np.lib.format.open_memmap(tmp_path / f"co{k}.npy", mode="w+", dtype=np.float64,
                                       shape=(h, w))
        mm[:] = scene["sigma0_co_db"]
        lazy.append(dict(
            inc=LazyRows(lambda a, b, x=scene["inc"]: x[a:b], (h, w)),
            sigma0_co_db=np.load(tmp_path / f"co{k}.npy", mmap_mode="r"),
            sigma0_cr_db=LazyRows(lambda a, b, x=scene["sigma0_cr_db"]: x[a:b], (h, w)),
            dsig_cr=0.25,
            ancillary_wind=LazyRows(lambda a, b, x=scene["ancillary_wind"]: x[a:b], (h, w),
                                    dtype=np.complex128)))
    piece = 1024  # 3320 px: 4 pieces, one spanning the scenes' boundary
    ref = par.invert_scenes(tt, eager, par.make_mesh(4, 2, devices=CPU8), chunk_size=64)
    for kw in (dict(mesh=par.make_mesh(4, 2, devices=CPU8)), dict(mesh=None, device="cpu")):
        got = par.invert_scenes(tt, lazy, chunk_size=64, piece_size=piece, **kw)
        for (co_r, dual_r), (co_g, dual_g) in zip(ref, got):
            np.testing.assert_array_equal(co_g, co_r)
            np.testing.assert_array_equal(dual_g, dual_r)
    for scene, (h, w) in zip(lazy, shapes):
        for name, arr in scene.items():
            if isinstance(arr, LazyRows):
                assert 0 < arr.max_request <= piece + 2 * w, (name, arr.max_request)


@pytest.mark.parametrize("mode", ["fused", "fused_exact"])
def test_invert_scenes_fused_modes(f32, mode):
    """The fused modes over a data-only mesh, a scene at a time equal to the
    one-device fused path (which equals JAX's Pallas path:
    tests/test_torch_inversion.py, tests/test_torch_fused_exact.py)."""
    _, tt = f32
    scenes = _scenes([(12, 20), (10, 16)])
    outs = par.invert_scenes(tt, scenes, par.make_mesh(2, 1, devices=CPU8), mode=mode)
    for scene, (co, dual) in zip(scenes, outs):
        _same((co.reshape(-1), dual.reshape(-1)),
              invert_pixels(tt, *_flat(scene), mode=mode, device="cpu"))


# ---------------------------------------------------------------- the streaks

def test_sharded_streaks_histogram_matches_single_device():
    """The line-sharded streaks == the one-device core, and == the JAX
    sharded pipeline on its eight-device mesh."""
    rng = np.random.default_rng(3)
    ny, nx = 512, 384
    y, x = np.mgrid[0:ny, 0:nx]
    img = np.abs(1.0 + 0.5 * np.sin(0.35 * (x + 0.6 * y)) + 0.1 * rng.normal(size=(ny, nx))) \
        + 0.01
    win = 32
    cl = np.arange(4, ny // 4 - 4, 6)
    cs = np.arange(4, nx // 4 - 4, 9)
    bins = G._angle_bin_centers(72)
    w_ref, r_ref = (t.numpy() for t in G.streaks_histogram_core(img, cl, cs, win, bins,
                                                                device="cpu"))
    w_ref = w_ref.reshape(len(cl), len(cs), -1)
    r_ref = r_ref.reshape(len(cl), len(cs))
    for n_data in (8, 3):
        w, r = par.sharded_streaks_histogram(img, cl, cs, win, bins,
                                             par.make_mesh(n_data, 1, devices=CPU8))
        assert w.shape == w_ref.shape and r.shape == r_ref.shape
        np.testing.assert_allclose(w, w_ref, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(r, r_ref, rtol=1e-10, atol=1e-12)
    jw, jr = jpar.sharded_streaks_histogram(img, cl.astype(np.int32), cs.astype(np.int32), win,
                                            bins, jpar.make_mesh(8, 1))
    np.testing.assert_allclose(w, jw, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r, jr, rtol=1e-10, atol=1e-12)


def test_parallel_starts_no_process_group(f64):
    _, tt = f64
    par.sharded_invert_pixels(tt, *make_pixels(64), mesh=par.make_mesh(2, 2, devices=CPU8))
    assert not (torch.distributed.is_available() and torch.distributed.is_initialized())
