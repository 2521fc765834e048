"""The port's spans and counters (``xsarsea_tpu_torch.utils.spans``) on the CPU.

* under ``torch.profiler``, ``invert_pixels(..., mode="fused")`` and a dual-pol
  ``invert_from_model`` put their spans in the trace, each inside the span
  that holds it (``xs.call`` > ``xs.compute`` > ``xs.coarse`` ...); the
  calling thread's spans only under a default profiler, the lanes' workers'
  too under ``utils.trace``. ``xs.pin`` and ``xs.wait.copy`` are on the card's
  path: here through a pool whose allocator pins nothing and a copy whose
  event is a stand-in;
* with no profiler, ``span()`` is one shared null context and no
  ``record_function`` is entered; no call record is kept;
* inside ``utils.trace``, one record per call, whose pieces and launches are
  the counters' changes, written into the trace file too; its
  ``perm_rows_read`` the slots K1-K4 read through the bucket permutation;
* the kernel modules' ``launch_counts()`` and ``reset_launch_counts()`` keep
  their results on the shared counters, which lose no update under threads;
* ``timing`` reads nothing when its log is off;
* ``scripts/bench_spans`` runs.
"""

import copy
import json
import logging
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch import utils as u
from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.scripts import bench_spans
from xsarsea_tpu_torch.utils import spans, staging
from xsarsea_tpu_torch.windspeed import inversion as inv

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
N = 600
# each span and the span it runs inside
PARENT = {"xs.validate": "xs.call", "xs.tables": "xs.call", "xs.build": "xs.tables",
          "xs.prep": "xs.call", "xs.compute": "xs.call", "xs.bucket": "xs.compute",
          "xs.coarse": "xs.compute", "xs.rebucket": "xs.compute", "xs.refine": "xs.compute",
          "xs.post": "xs.compute", "xs.wait.prep": "xs.call", "xs.wait.drain": "xs.call",
          "xs.drain": "xs.call", "xs.cat": "xs.call", "xs.merge": "xs.call",
          "xs.pin": "xs.prep", "xs.read": "xs.prep", "xs.wait.copy": "xs.drain"}
# the spans of the lanes' workers, inside the call's time but on their own threads
LANES = {"xs.prep", "xs.pin", "xs.drain", "xs.wait.copy"}


def _scene(n=N, seed=0):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)) / 10.0)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc - 30.0)) / 10.0)
    anc = wspd * np.exp(1j * np.deg2rad(phi))
    return inc, s0_co, s0_cr, anc


def _db(x):
    return (10.0 * np.log10(x + 1e-15)).astype(np.float32)


@pytest.fixture
def tables():
    """Fresh fused tables: their first call builds the closure (``xs.build``)."""
    t = copy.copy(inv.prepare_tables(*MODEL, dtype=torch.float32, **KW))
    t._invert_fn_cache, t._device_copies = {}, {}
    return t


def _pixels(tables, piece_size=None, device_output=False):
    inc, s0_co, s0_cr, anc = _scene()
    return inv.invert_pixels(tables, inc.astype(np.float32), _db(s0_co), _db(s0_cr),
                             np.full(N, 0.1, np.float32), anc.astype(np.complex64),
                             mode="fused", device="cpu", piece_size=piece_size,
                             device_output=device_output)


def _from_model():
    inc, s0_co, s0_cr, anc = _scene(seed=1)
    return inv.invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=0.1,
                                 model=MODEL, mode="fused", dtype=torch.float32,
                                 device="cpu", **KW)


def _xs_events(events):
    return [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("xs.")]


def _inside(e, p):
    return p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def _check_nesting(events):
    """Every span lies inside a span of its parent's name on its thread (a
    lane worker's outermost span inside a call); returns the names seen."""
    callers = {e["tid"] for e in events if e["name"] == "xs.call"}
    for e in events:
        parent = PARENT.get(e["name"])
        if parent is None:
            assert e["name"] == "xs.call", e["name"]
        elif not any(p["name"] == parent and p["tid"] == e["tid"] and _inside(e, p)
                     for p in events):
            assert e["tid"] not in callers and e["name"] in LANES, e
            assert any(p["name"] == "xs.call" and _inside(e, p) for p in events), e
    return {e["name"] for e in events}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _trace_events(tmp_path, fn):
    with u.trace(tmp_path / "trace") as tr:
        fn()
    with open(tr.path) as f:
        return tr, json.load(f)


def test_invert_pixels_spans_nest_as_documented(tables, tmp_path):
    tr, doc = _trace_events(tmp_path, lambda: (_pixels(tables),
                                               _pixels(tables, 250, device_output=True)))
    events = _xs_events(doc["traceEvents"])
    assert _check_nesting(events) >= {
        "xs.call", "xs.tables", "xs.build", "xs.prep", "xs.compute", "xs.bucket", "xs.coarse",
        "xs.rebucket", "xs.refine", "xs.post", "xs.drain", "xs.wait.prep", "xs.cat"}
    calls = [e for e in events if e["name"] == "xs.call"]
    assert len(calls) == 2 and len({e["tid"] for e in calls}) == 1
    # three pieces: three computes and their stages, in the second call
    second = calls[1]
    inside = [e for e in events if e["ts"] >= second["ts"]
              and e["ts"] + e["dur"] <= second["ts"] + second["dur"]]
    assert sum(e["name"] == "xs.compute" for e in inside) == 3
    assert sum(e["name"] == "xs.coarse" for e in inside) == 3
    if u._all_threads_config() is not None:  # the lanes' worker prepares pieces 2 and 3
        assert any(e["name"] == "xs.prep" and e["tid"] != calls[0]["tid"] for e in events)


def test_default_profiler_sees_the_calling_threads_spans():
    tables = inv.prepare_tables(*MODEL, dtype=torch.float32, **KW)
    _pixels(tables)  # the closure built outside the profile
    names = [e.name for e in _profiled(lambda: _pixels(tables, 250))]
    xs = {n for n in names if n.startswith("xs.")}
    assert {"xs.call", "xs.tables", "xs.compute", "xs.coarse", "xs.wait.prep",
            "xs.wait.drain"} <= xs
    assert "xs.build" not in xs
    # three pieces: the first prepared on the worker or here, the drains on the worker
    assert names.count("xs.compute") == 3


def test_dual_pol_invert_from_model_spans(tmp_path):
    _, doc = _trace_events(tmp_path, _from_model)
    seen = _check_nesting(_xs_events(doc["traceEvents"]))
    assert {"xs.call", "xs.validate", "xs.tables", "xs.prep", "xs.read", "xs.compute",
            "xs.coarse", "xs.refine", "xs.drain", "xs.merge"} <= seen


def test_pin_and_copy_wait_spans(monkeypatch):
    pool = staging.PinnedPool()
    monkeypatch.setattr(staging.PinnedPool, "_alloc",
                        staticmethod(lambda n: torch.empty(n, dtype=torch.uint8)))
    monkeypatch.setattr(staging, "_POOL", pool)
    before = spans.counters()["pinned_new_bytes"]

    def work():
        buf = pool.take(100_000)
        copy_ = staging.HostCopy.__new__(staging.HostCopy)
        copy_._buf, copy_._host = buf, pool.view(buf, (4,), torch.float32)
        copy_._host.copy_(torch.arange(4.0))
        copy_._done = SimpleNamespace(synchronize=lambda: None)
        out = np.empty(4, np.float32)
        with spans.span("xs.drain"):
            copy_.into(out)
        np.testing.assert_array_equal(out, np.arange(4.0, dtype=np.float32))

    names = [e.name for e in _profiled(work)]
    assert "xs.pin" in names and "xs.wait.copy" in names
    assert spans.counters()["pinned_new_bytes"] - before == 1 << 17  # a power of two


def test_no_profiler_enters_no_record_function_and_keeps_no_record(tables, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span("xs.call") is spans.span("xs.prep") is spans._NULL
    _pixels(tables, 250)
    _from_model()
    assert spans._calls is None
    assert spans.stop_recording() == []


def test_trace_records_one_per_call(tables, tmp_path, monkeypatch):
    piece = 250
    slots = []  # the slots of each K1-K4 launch, read through the bucket permutation
    for name in K.KERNELS:
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _f=fn, **kw: slots.append(kw["index"].numel())
                            or _f(*a, **kw))
    split = []
    before = K.launch_counts()
    tr, doc = _trace_events(tmp_path, lambda: (_pixels(tables, piece), split.append(len(slots)),
                                               _from_model()))
    after = K.launch_counts()
    assert [c["entry"] for c in tr.calls] == ["invert_pixels", "invert_from_model"]
    pix, model = tr.calls
    assert pix["pieces"] == len(inv._pieces(N, piece)) == 3
    assert model["pieces"] == len(inv._pieces(N, 1 << 22)) == 1
    assert pix["pixels"] == model["pixels"] == N
    assert pix["builds"] == 1 and model["builds"] == 0  # the fresh tables' closure
    launched = {k: after[k] - before.get(k, 0) for k in after}
    for rec in tr.calls:
        got = {k[len("launch/"):]: v for k, v in rec.items() if k.startswith("launch/")}
        assert {k: v for k, v in got.items() if v} == {k: v for k, v in launched.items() if v}
        assert rec["seconds"] > 0 and rec["alloc_segments"] == 0
        assert rec["h2d_bytes"] == rec["d2h_bytes"] == 0  # no card: no copy counted
        assert rec["pinned_bytes"] == staging.pool().bytes
    assert pix["perm_rows_read"] == sum(slots[:split[0]]) > 0
    assert model["perm_rows_read"] == sum(slots[split[0]:]) > 0
    assert doc["xs_calls"] == tr.calls
    assert spans._calls is None  # recording ends with the trace


def test_launch_counts_keep_their_results():
    K.reset_launch_counts()
    E.reset_launch_counts()
    try:
        assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
        assert E.launch_counts() == {}
        K._count("group_argmin")
        K._count("slab_refine", 16)
        E._count("slab_forms/direct")
        assert K.launch_counts() == {**dict.fromkeys(K.KERNELS, 0), "group_argmin": 1,
                                     "slab_refine:chunk_rows=16": 1}
        assert E.launch_counts() == {"slab_forms/direct": 1}
        assert spans.counters("launch/")["group_argmin"] == 1
        K.reset_launch_counts()
        assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
        assert E.launch_counts() == {"slab_forms/direct": 1}
    finally:
        K.reset_launch_counts()
        E.reset_launch_counts()


def test_counters_lose_no_update_under_threads():
    workers, adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [spans.count("test.stress")
                                                    for _ in range(adds)])
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert spans.counters("test.")["stress"] == workers * adds
    finally:
        sys.setswitchinterval(old)
        spans.reset("test.")


@pytest.mark.parametrize("level,reads", [(logging.WARNING, False), (logging.INFO, True)])
def test_timing_reads_nothing_when_its_log_is_off(monkeypatch, level, reads):
    seen = []
    monkeypatch.setattr(u, "_rss_mb", lambda: seen.append("rss") or 0.0)
    monkeypatch.setattr(u, "device_memory_stats", lambda: seen.append("device") or {})
    old = u.logger.level
    u.logger.setLevel(level)
    try:
        _from_model()
    finally:
        u.logger.setLevel(old)
    assert bool(seen) is reads
    if reads:
        assert {"rss", "device"} <= set(seen)


def test_bench_spans_runs_on_the_cpu():
    rec = bench_spans.main(n=20_000, n_on=500, device="cpu")
    assert rec["device"] == "cpu" and rec["on_ns"] > rec["off_ns"] > 0
    assert "bench_spans" not in spans.counters()
