"""The port's piece loop and host staging, on the CPU.

* the overlapped loop (a worker preparing piece k+1, the caller computing
  piece k, a second worker draining piece k-1) against the serial loop
  (``_overlap=False``): bit for bit, NaN payloads included, for ``exact`` in
  float64 and ``fused`` in float32, 1, 2 and 5 pieces with a ragged tail, flat
  prepared arrays and lazy row sources;
* the wire-format cases of tests/test_wire_format.py that the port has a
  counterpart for: missing streams, a scalar ``dsig_cr`` across pieces,
  ``device_db`` resolved per call and ``False`` respected, a vector
  incidence; outputs against the JAX package's ``exact`` mode up to the
  phi = +-180 deg tie and 1e-13 relative (tests/test_torch_inversion.py);
* host staging stays bounded by the piece, in traced host memory and in the
  pinned pool's own byte count (tracemalloc does not see pinned memory); the
  pool itself with an allocator that pins nothing (this host has no card).
"""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu_torch.utils import staging
from xsarsea_tpu_torch.windspeed import inversion as inv
from xsarsea_tpu_torch.windspeed.inversion import (_invert_source, _LazySource, _PreparedSource,
                                                   invert_from_model, invert_pixels,
                                                   prepare_tables)

from test_streaming import LazyRows, _lazy_scene
from test_torch_inversion import F64_TRIG, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
MODES = [("exact", torch.float64), ("fused", torch.float32)]


def _scene(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)) / 10.0) \
        * rng.uniform(0.8, 1.2, n)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc - 30.0)) / 10.0)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    inc[0], s0_co[1], anc[2], s0_cr[3] = np.nan, np.nan, np.nan, np.nan
    return inc, s0_co, s0_cr, anc


def _db(x):
    return 10.0 * np.log10(np.asarray(x, np.float64) + 1e-15)


def same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def assert_same_bits(got, ref):
    for g, r in zip(got, ref):
        assert same_bits(g, r)


# ------------------------------------------------- overlapped against serial

@pytest.mark.parametrize("mode,dtype", MODES)
@pytest.mark.parametrize("pieces", [1, 2, 5])
def test_overlapped_equals_serial_prepared_source(mode, dtype, pieces):
    # the fused path's plain kernels are slow on the CPU: a smaller scene for them
    n = 2500 if mode == "exact" else 900
    piece = {1: None, 2: n // 2 + 50, 5: n // 5 + 20}[pieces]  # the last piece ragged
    inc, s0_co, s0_cr, anc = _scene(n=n, seed=1)
    tables = prepare_tables(*MODEL, dtype=dtype, **KW)
    assert len(inv._pieces(n, piece or 1 << 22)) == pieces

    def run(**kw):
        src = _PreparedSource(inc, _db(s0_co), _db(s0_cr), np.full(n, 0.3), anc)
        return _invert_source(tables, src, mode=mode, device="cpu", piece_size=piece, **kw)

    serial = run(_overlap=False)
    assert serial[0].dtype == (np.complex128 if dtype == torch.float64 else np.complex64)
    assert_same_bits(run(), serial)
    assert_same_bits(run(), serial)  # and again: no order of the lanes shows in the result
    # pieces change nothing but the tail's padding: one piece gives the same winds
    assert_same_bits(serial, _invert_source(
        tables, _PreparedSource(inc, _db(s0_co), _db(s0_cr), np.full(n, 0.3), anc),
        mode=mode, device="cpu", _overlap=False))
    # results kept on the device: the same values as complex tensors
    dev = run(device_output=True)
    assert all(isinstance(t, torch.Tensor) and t.is_complex() for t in dev)
    assert_same_bits([t.numpy() for t in dev], serial)
    assert_same_bits([t.numpy() for t in run(device_output=True, _overlap=False)], serial)


@pytest.mark.parametrize("mode,dtype", MODES)
def test_overlapped_equals_serial_lazy_rows(mode, dtype):
    """Lazy row sources through ``invert_from_model``: the overlapped loop (the
    default) equals the serial one and the eager call, and asks no source for
    more than a piece and the partial rows at its two ends."""
    ny, nx = 96, 110  # 10,560 px; pieces of 2,048: six, the last ragged
    (inc, s0_co, s0_cr, dsig_cr, anc), lazy = _lazy_scene(ny, nx)
    piece = 2048
    kw = dict(model=MODEL, mode=mode, dtype=dtype, device="cpu", device_db=False, **KW)
    eager = invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=dsig_cr, **kw)
    got = invert_from_model(lazy["inc"], lazy["s0_co"], lazy["s0_cr"],
                            ancillary_wind=lazy["anc"], dsig_cr=lazy["dsig_cr"],
                            piece_size=piece, **kw)
    assert_same_bits(got, eager)
    for name, arr in lazy.items():
        assert 0 < arr.max_request <= piece + 2 * nx, (name, arr.max_request)
    tables = prepare_tables(*MODEL, dtype=dtype, **KW)

    def source():
        return _LazySource((ny, nx), lazy["inc"], s0_co=lazy["s0_co"], s0_cr=lazy["s0_cr"],
                           dsig_cr=lazy["dsig_cr"], anc=lazy["anc"], device_db=False)

    serial = _invert_source(tables, source(), mode=mode, device="cpu", piece_size=piece,
                            _overlap=False)
    overlapped = _invert_source(tables, source(), mode=mode, device="cpu", piece_size=piece)
    assert_same_bits(overlapped, serial)
    if mode == "exact":  # the dual-pol merge aside, these are the eager call's winds
        assert same_bits(serial[0].reshape(ny, nx), eager[0])
        jco, _ = jinv.invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=dsig_cr,
                                        model=MODEL, mode="exact", device_db=False, **KW)
        assert_parity(serial[0], np.asarray(jco).reshape(-1), F64_TRIG)


def test_overlapped_loop_runs_its_lanes_on_other_threads():
    """The preparation of piece k+1 runs on a worker while the caller
    computes; a failure in a lane reaches the caller."""
    inc, s0_co, s0_cr, anc = _scene(n=1500, seed=2)
    tables = prepare_tables(*MODEL, dtype=torch.float64, **KW)
    seen = []

    class Watching(_PreparedSource):
        def streams(self, lo, hi, device, dtype):
            seen.append((lo, threading.current_thread() is threading.main_thread()))
            return super().streams(lo, hi, device, dtype)

    args = (inc, _db(s0_co), _db(s0_cr), np.full(1500, 0.1), anc)
    _invert_source(tables, Watching(*args), mode="exact", device="cpu", piece_size=400)
    assert [lo for lo, _ in seen] == [0, 400, 800, 1200] and not any(m for _, m in seen)
    seen.clear()
    _invert_source(tables, Watching(*args), mode="exact", device="cpu", piece_size=400,
                   _overlap=False)
    assert all(m for _, m in seen) and len(seen) == 4
    # tensors on the device in, tensors out: a piece is a view, no lane is started
    seen.clear()
    tensors = [torch.as_tensor(a) for a in args]
    resident = _invert_source(tables, Watching(*tensors), mode="exact", device="cpu",
                              piece_size=400, device_output=True)
    assert all(m for _, m in seen) and len(seen) == 4
    assert_same_bits([t.numpy() for t in resident],
                     _invert_source(tables, Watching(*args), mode="exact", device="cpu"))

    class Failing(_PreparedSource):
        def streams(self, lo, hi, device, dtype):
            if lo >= 800:
                raise OSError("the source went away")
            return super().streams(lo, hi, device, dtype)

    with pytest.raises(OSError, match="went away"):
        _invert_source(tables, Failing(*args), mode="exact", device="cpu", piece_size=400)


# ------------------------------------------------------------- wire format

def test_stream_skip_bit_identical_to_full_streams():
    """Missing streams + scalar dsig == explicit NaN/full streams (exact)."""
    inc, _, s0_cr, _ = _scene()
    tables = prepare_tables(None, "gmf_s1_v2", dtype=torch.float64, **KW)
    src = _LazySource((inc.shape[0],), inc, s0_cr=s0_cr, dsig_cr=0.1, device_db=False)
    co_s, dual_s = _invert_source(tables, src, mode="exact", device="cpu", piece_size=1000)
    nanv = np.full_like(inc, np.nan)
    co_f, dual_f = invert_pixels(tables, inc, nanv, _db(s0_cr), np.full_like(inc, 0.1),
                                 nanv + 0j, mode="exact", device="cpu")
    assert same_bits(dual_s, dual_f) and same_bits(co_s, co_f)
    jt = jinv.prepare_tables(None, "gmf_s1_v2", dtype=np.float64, **KW)
    jco, jdual = jinv.invert_pixels(jt, inc, nanv, _db(s0_cr), np.full_like(inc, 0.1),
                                    nanv + 0j, mode="exact")
    assert_parity(dual_s, np.asarray(jdual), F64_TRIG)


def test_scalar_dsig_across_pieces():
    inc, s0_co, s0_cr, anc = _scene(n=2500)
    tables = prepare_tables(*MODEL, dtype=torch.float64, **KW)

    def mk():
        return _LazySource((2500,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc,
                           device_db=False)

    one = _invert_source(tables, mk(), mode="exact", device="cpu")
    many = _invert_source(tables, mk(), mode="exact", device="cpu", piece_size=1000)
    assert_same_bits(many, one)
    full = _LazySource((2500,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=np.full(2500, 0.1),
                       anc=anc, device_db=False)
    assert_same_bits(_invert_source(tables, full, mode="exact", device="cpu", piece_size=1000),
                     one)


def test_device_db_auto_per_call_and_false_respected():
    inc, s0_co, s0_cr, anc = _scene(n=2048, seed=3)
    t32 = prepare_tables(*MODEL, dtype=torch.float32, **KW)

    def mk(**kw):
        return _LazySource((2048,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc, **kw)

    src = mk()
    assert src.device_db is None
    co_d, dual_d = _invert_source(t32, src, mode="fused", device="cpu", piece_size=600)
    # resolved per call, on a copy: the caller's source is not stamped, so an
    # exact call after a fused one keeps the host's float64 dB conversion
    assert src.device_db is None
    assert_same_bits(_invert_source(t32, src, mode="exact", device="cpu"),
                     _invert_source(t32, mk(), mode="exact", device="cpu"))
    # linear float32 on the wire when the conversion is the device's, dB when the host's
    lin = mk(device_db=True).streams(0, 8, torch.device("cpu"), torch.float32)[1]
    np.testing.assert_array_equal(
        lin.numpy(), (10.0 * torch.log10(torch.as_tensor(s0_co[:8].astype(np.float32))
                                         + 1e-15)).numpy())
    host = mk(device_db=False)
    np.testing.assert_array_equal(
        host.streams(0, 8, torch.device("cpu"), torch.float32)[1].numpy(),
        _db(s0_co[:8]).astype(np.float32))
    co_h, dual_h = _invert_source(t32, host, mode="fused", device="cpu", piece_size=600)
    assert host.device_db is False  # the explicit choice is respected
    assert_same_bits(_invert_source(t32, mk(device_db=True), mode="fused", device="cpu"),
                     (co_d, dual_d))
    for got, ref in ((co_d, co_h), (dual_d, dual_h)):
        sg, sr = np.abs(got), np.abs(ref)
        np.testing.assert_array_equal(np.isnan(sg), np.isnan(sr))
        m = ~np.isnan(sr)
        # float32-ulp differences in dB move at most one grid step, rarely
        assert np.max(np.abs(sg[m] - sr[m])) <= 0.5 + 1e-6 and np.mean(sg[m] != sr[m]) < 0.01
    # the exact float64 path never converts on the device by itself
    t64 = prepare_tables(*MODEL, dtype=torch.float64, **KW)
    src64 = mk()
    ref64 = _invert_source(t64, mk(device_db=False), mode="exact", device="cpu")
    assert_same_bits(_invert_source(t64, src64, mode="exact", device="cpu"), ref64)
    assert not src64.device_db


def test_vector_incidence_across_pieces():
    ny, nx = 40, 64
    rng = np.random.default_rng(11)
    inc_vec = np.linspace(18.0, 47.0, nx)
    wspd = rng.uniform(0.5, 45.0, (ny, nx))
    phi = rng.uniform(0.0, 360.0, (ny, nx))
    inc_full = np.ascontiguousarray(np.broadcast_to(inc_vec, (ny, nx)))
    s0_co = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc_full - 30.0)) / 10.0)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc_full - 30.0)) / 10.0)
    anc = wspd * np.exp(1j * np.deg2rad(phi))
    tables = prepare_tables(*MODEL, dtype=torch.float64, **KW)

    def run(inc_arg, **kw):
        src = _LazySource((ny, nx), inc_arg, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc,
                          device_db=False)
        return src, _invert_source(tables, src, mode="exact", device="cpu", **kw)

    src_f, ref = run(inc_full)
    assert src_f.inc_mode == "full"
    for shape in ((nx,), (1, nx)):
        # a piece boundary that is no row boundary, overlapped and serial
        for kw in (dict(), dict(piece_size=1000), dict(piece_size=1000, _overlap=False)):
            src_v, got = run(inc_vec.reshape(shape), **kw)
            assert src_v.inc_mode == "sample"
            assert_same_bits(got, ref)
    src_s, got_s = run(np.float64(35.0), piece_size=512)
    assert src_s.inc_mode == "sample" and src_s._inc_div == 1
    assert_same_bits(got_s, run(np.full((ny, nx), 35.0))[1])
    inc_line = np.linspace(18.0, 47.0, ny).reshape(ny, 1)
    src_l, got_l = run(inc_line, piece_size=700)
    assert src_l.inc_mode == "line"
    assert_same_bits(got_l, run(np.ascontiguousarray(np.broadcast_to(inc_line, (ny, nx))))[1])
    with pytest.raises(ValueError, match="broadcastable"):
        _LazySource((ny, nx), np.zeros(ny), s0_co=s0_co, dsig_cr=0.1, anc=anc)


# ------------------------------------------------------------ host staging

def test_host_staging_is_piece_bounded():
    """Peak host allocations during streaming stay far below full-scene
    float64 staging, and the pinned pool holds what it held before: on the
    CPU no pinned buffer is taken."""
    ny, nx = 256, 256  # 65,536 px
    (inc, s0_co, s0_cr, dsig_cr, anc), lazy = _lazy_scene(ny, nx)
    n, piece = ny * nx, 4096
    kw = dict(model=MODEL, mode="exact", piece_size=piece, device="cpu", **KW)
    _, warm = _lazy_scene(96, 96)  # tables and every cache, outside the measured window
    invert_from_model(warm["inc"], warm["s0_co"], warm["s0_cr"], ancillary_wind=warm["anc"],
                      dsig_cr=warm["dsig_cr"], **kw)
    pinned = staging.pool().bytes, staging.pool().peak_bytes
    tracemalloc.start()
    invert_from_model(lazy["inc"], lazy["s0_co"], lazy["s0_cr"], ancillary_wind=lazy["anc"],
                      dsig_cr=lazy["dsig_cr"], **kw)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    # outputs: 2 complex128 arrays. Eager staging would add ~6 full-scene
    # f64/c128 temporaries (>= 48 B/px); allow the outputs and a piece-scaled slack
    outputs = 2 * n * 16
    slack = 40 * piece * 16  # pieces in flight across three lanes
    assert peak < outputs + slack, f"peak {peak / 1e6:.1f} MB suggests full-scene staging"
    assert (staging.pool().bytes, staging.pool().peak_bytes) == pinned
    for name, arr in lazy.items():
        assert 0 < arr.max_request <= piece + 2 * nx, (name, arr.max_request)


class _Event:
    """A stand-in for a CUDA event: fired when told."""

    def __init__(self, fired=False):
        self.fired = fired

    def query(self):
        return self.fired


@pytest.fixture
def unpinned_pool():
    """A pool whose buffers are plain host memory (no card here to pin for)."""
    p = staging.PinnedPool(cap_bytes=1 << 20)
    p._alloc = lambda nbytes: torch.empty(nbytes, dtype=torch.uint8)
    return p


def test_pinned_pool_reuses_counts_and_caps(unpinned_pool):
    p = unpinned_pool
    a, b = p.take(100_000), p.take(300_000)
    assert (a.numel(), b.numel()) == (1 << 17, 1 << 19) and p.bytes == (1 << 17) + (1 << 19)
    assert p.take(10).numel() == 1 << 16  # the smallest buffer is 64 KiB
    p.give(b)
    p.give(a)
    assert p.take(70_000) is a and p.take(200_000) is b  # the smallest that fits, by identity
    assert p.bytes == p.peak_bytes == (1 << 17) + (1 << 19) + (1 << 16)
    # a buffer given back with an event waits until it has fired
    ev = _Event()
    p.give(a, after=ev)
    c = p.take(100_000)
    assert c is not a and p.bytes == 2 * (1 << 17) + (1 << 19) + (1 << 16)
    ev.fired = True
    assert p.take(100_000) is a
    # beyond the cap, free buffers are dropped, the largest first
    big = p.take(3 << 20)
    assert p.bytes > p.cap_bytes
    p.give(big)
    p.give(b)
    assert p.bytes <= p.cap_bytes and p.peak_bytes >= 4 << 20
    # a view of a buffer's head in any dtype and shape
    v = p.view(c, (5, 7), torch.complex64)
    assert v.shape == (5, 7) and v.dtype == torch.complex64 and v.data_ptr() == c.data_ptr()


def test_pinned_pool_is_thread_safe(unpinned_pool):
    """More workers than cores take and give at once: no buffer is lent twice
    and the byte count matches the buffers that exist."""
    import sys

    p = unpinned_pool
    p.cap_bytes = 1 << 40
    lent, lock, errors = set(), threading.Lock(), []
    made = []
    alloc = p._alloc
    p._alloc = lambda nbytes: made.append(alloc(nbytes)) or made[-1]

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            buf = p.take(int(rng.integers(1, 1 << 18)))
            with lock:
                if buf.data_ptr() in lent:
                    errors.append("a buffer was lent twice")
                lent.add(buf.data_ptr())
            with lock:
                lent.discard(buf.data_ptr())
            p.give(buf, after=_Event(fired=bool(rng.integers(0, 2))))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert p.bytes == sum(b.numel() for b in made)


def test_staging_on_the_cpu_is_plain_conversion():
    pinned = staging.pool().bytes
    a = np.random.default_rng(0).normal(size=(300, 200))
    t = staging.to_device(a, "cpu", torch.float32)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))
    assert staging.to_device(a, "cpu").dtype == torch.float64
    assert staging.to_device(t, "cpu") is t  # a tensor where it should be stays itself
    strided = staging.to_device(a[::2, ::3].real, "cpu", torch.float64)
    np.testing.assert_array_equal(strided.numpy(), a[::2, ::3])
    z = torch.as_tensor(a[:7] + 1j * a[7:14])
    assert np.shares_memory(staging.to_host(z), z.numpy())  # a CPU tensor's own memory
    out = np.empty((2, 7, 200), dtype=np.complex128)
    assert staging.to_host(z, out=out[1]) is not None
    np.testing.assert_array_equal(out[1], z.numpy())
    flat = np.zeros(1400, dtype=np.complex128)
    staging.HostCopy(z.reshape(-1)).into(flat[:1400])
    np.testing.assert_array_equal(flat, z.numpy().reshape(-1))
    half = np.zeros(2800)
    staging.HostCopy(z.real.reshape(-1)).into(half[::2])  # a strided 1-D destination
    np.testing.assert_array_equal(half[::2], z.real.numpy().reshape(-1))
    assert staging.pool().bytes == pinned
    assert staging.np_dtype(torch.complex64) == np.complex64
    assert staging.torch_dtype(np.int32) == torch.int32 == staging.torch_dtype(torch.int32)


def test_prefault_touches_one_byte_a_page_on_a_worker():
    """``prefault`` writes 0 into the first byte of each page of each array,
    on another thread, and leaves the other bytes as they were."""
    import mmap
    import threading

    page = mmap.PAGESIZE
    a = np.full(5 * page + 3, 7, np.uint8)
    b = np.full((3, 1000), 1.5, np.complex64)
    seen = []
    touch = staging._touch
    try:
        staging._touch = lambda arrays: (seen.append(threading.get_ident()), touch(arrays))
        staging.prefault(a, b, np.empty(0, np.complex64)).result()
    finally:
        staging._touch = touch
    assert seen and seen[0] != threading.get_ident()
    first = np.zeros(a.size, bool)
    first[::page] = True
    assert (a[first] == 0).all() and (a[~first] == 7).all()
    raw = b.reshape(-1).view(np.uint8)
    assert (raw[::page] == 0).all() and raw.size > page
    np.testing.assert_array_equal(np.delete(b.reshape(-1).view(np.uint8), np.s_[::page]),
                                  np.delete(np.full((3, 1000), 1.5, np.complex64).reshape(-1)
                                            .view(np.uint8), np.s_[::page]))
