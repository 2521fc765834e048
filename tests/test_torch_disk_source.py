"""A scene read from disk: ``invert_from_model`` on ``.npy`` files opened with
``np.load(..., mmap_mode="r")``, as an archive chain hands an L1 product over
(float32 incidence on the full grid, float32 linear sigma0 VV and VH, a float32
``dsig_cr``, a complex64 ancillary wind), in pieces through the overlapped
lanes, on the CPU:

* the overlapped lanes give the bits of the serial loop and of the same
  arrays in memory in one piece;
* ``read_bytes`` counts every byte the pieces read from the files, once;
* ``xs.read`` is recorded on the prep worker under ``utils.trace``, inside
  its ``xs.prep``;
* the scene's coastal block of NaN sigma0 gives the NaN pattern of the
  in-memory run.
"""

import json

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch import utils as u
from xsarsea_tpu_torch.utils import spans
from xsarsea_tpu_torch.windspeed import inversion as inv

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
SHAPE = (160, 240)
PIECE = 12_000  # four pieces, the last ragged
BYTES_PER_PX = 4 + 4 + 4 + 4 + 8  # inc, VV, VH, dsig_cr, the complex64 wind
COAST = 57  # samples of NaN sigma0 on the far side


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    ny, nx = SHAPE
    inc = np.linspace(19.0, 47.0, nx)[None, :].repeat(ny, 0)
    wspd = rng.uniform(0.5, 30.0, SHAPE)
    phi = rng.uniform(0.0, 360.0, SHAPE)
    s0_co = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)) / 10.0)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc - 30.0)) / 10.0)
    s0_co *= 10 ** (rng.normal(0.0, 0.03, SHAPE))
    s0_cr *= 10 ** (rng.normal(0.0, 0.05, SHAPE))
    s0_co[:, nx - COAST:] = np.nan
    s0_cr[:, nx - COAST:] = np.nan
    anc = (wspd + rng.normal(0.0, 1.5, SHAPE)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    return {"inc": inc.astype(np.float32), "s0_co": s0_co.astype(np.float32),
            "s0_cr": s0_cr.astype(np.float32),
            "dsig_cr": rng.uniform(0.05, 0.2, SHAPE).astype(np.float32),
            "anc": anc.astype(np.complex64)}


def _invert(a, **kw):
    return inv.invert_from_model(a["inc"], a["s0_co"], a["s0_cr"], ancillary_wind=a["anc"],
                                 dsig_cr=a["dsig_cr"], model=MODEL, mode="fused",
                                 dtype=torch.float32, device="cpu", **KW, **kw)


def _lazy(a):
    return inv._LazySource(SHAPE, a["inc"], s0_co=a["s0_co"], s0_cr=a["s0_cr"],
                           dsig_cr=a["dsig_cr"], anc=a["anc"])


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene written as ``.npy`` files and memory-mapped back; the runs
    the tests compare: in memory in one piece, from the files through the
    lanes under ``utils.trace``, and from the files through the serial loop,
    each with the change of ``read_bytes``."""
    d = tmp_path_factory.mktemp("scene")
    scene = _scene()
    for k, a in scene.items():
        np.save(d / f"{k}.npy", a)
    files = {k: np.load(d / f"{k}.npy", mmap_mode="r") for k in scene}
    assert all(isinstance(a, np.memmap) for a in files.values())
    memory = {k: np.load(d / f"{k}.npy") for k in scene}
    assert not any(isinstance(a, np.memmap) for a in memory.values())
    tables = inv.prepare_tables(*MODEL, dtype=torch.float32, **KW)

    def read(fn):
        before = spans.counters()["read_bytes"]
        out = fn()
        return out, spans.counters()["read_bytes"] - before

    out = {"in_memory": read(lambda: _invert(memory))}
    with u.trace(d / "trace") as tr:
        out["lanes"] = read(lambda: _invert(files, piece_size=PIECE))
    with open(tr.path) as f:
        out["events"] = [e for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "X" and e.get("name", "").startswith("xs.")]
    out["records"] = tr.calls
    source = _lazy(files)
    source.device_db = True  # as invert_from_model sets it for the float32 fused mode
    out["serial"] = read(lambda: inv._invert_source(tables, source, mode="fused", device="cpu",
                                                    piece_size=PIECE, _overlap=False))
    out["pieces"] = inv._pieces(SHAPE[0] * SHAPE[1], PIECE)
    return out


def test_lanes_from_files_are_bit_equal_to_serial_and_to_memory(runs):
    assert len(runs["pieces"]) >= 3
    (co, du), _ = runs["lanes"]
    (co_mem, du_mem), _ = runs["in_memory"]
    co_ser, du_ser = runs["serial"][0]
    assert co.shape == du.shape == SHAPE and co.dtype == du.dtype == np.complex64
    # the serial loop returns the unmerged dual wind: merge it as the call does
    take = (np.abs(co_ser) < 5.0) | (np.abs(du_ser) < 5.0)
    du_ser = np.where(take, co_ser, du_ser).reshape(SHAPE)
    np.testing.assert_array_equal(_bits(co), _bits(co_ser.reshape(SHAPE)))
    np.testing.assert_array_equal(_bits(du), _bits(du_ser))
    np.testing.assert_array_equal(_bits(co), _bits(co_mem))
    np.testing.assert_array_equal(_bits(du), _bits(du_mem))


def test_read_bytes_counts_what_the_pieces_read(runs):
    n = SHAPE[0] * SHAPE[1]
    assert runs["lanes"][1] == runs["serial"][1] == runs["in_memory"][1] == n * BYTES_PER_PX
    (rec,) = runs["records"]
    assert rec["entry"] == "invert_from_model" and rec["pixels"] == n
    assert rec["read_bytes"] == n * BYTES_PER_PX
    assert rec["pieces"] == len(runs["pieces"])


def test_read_span_is_on_the_prep_worker_inside_its_prep(runs):
    events = runs["events"]
    (call,) = [e for e in events if e["name"] == "xs.call"]
    reads = [e for e in events if e["name"] == "xs.read"]
    if u._all_threads_config() is None:  # this torch's profiler sees the caller only
        pytest.skip("the installed torch's profiler does not follow the lanes' workers")
    # five arrays read a piece, every piece prepared on the worker
    assert len(reads) == 5 * len(runs["pieces"])
    assert {e["tid"] for e in reads} and call["tid"] not in {e["tid"] for e in reads}
    preps = [e for e in events if e["name"] == "xs.prep"]
    for r in reads:
        assert any(p["tid"] == r["tid"] and p["ts"] <= r["ts"]
                   and r["ts"] + r["dur"] <= p["ts"] + p["dur"] for p in preps), r


def test_coastal_block_from_files_gives_the_in_memory_nan_pattern(runs):
    (co, du), _ = runs["lanes"]
    (co_mem, du_mem), _ = runs["in_memory"]
    for got, ref in ((co, co_mem), (du, du_mem)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    # the block inverts to NaN copol winds, the open sea to numbers
    assert np.isnan(co[:, SHAPE[1] - COAST:]).all()
    assert np.isfinite(co[:, :SHAPE[1] - COAST]).mean() > 0.99


def test_read_bytes_leaves_out_arrays_broadcast_to_the_scene():
    """A ``dsig_cr`` sample vector and a wind broadcast from one value add no
    bytes: the count is of the arrays that hold the scene's own values,
    read from memory or a tensor on the host alike."""
    a = _scene(1)
    n = SHAPE[0] * SHAPE[1]
    anc = np.broadcast_to(np.complex64(3 + 4j), SHAPE)
    inc = torch.from_numpy(a["inc"])
    dsig = torch.from_numpy(a["dsig_cr"][0]).expand(SHAPE)
    for dsig_cr, wind in ((a["dsig_cr"][0], anc), (dsig, torch.from_numpy(anc.copy()))):
        source = inv._LazySource(SHAPE, inc, s0_co=a["s0_co"], s0_cr=a["s0_cr"],
                                 dsig_cr=dsig_cr, anc=wind)
        before = spans.counters()["read_bytes"]
        for lo, hi in inv._pieces(n, PIECE):
            source.streams(lo, hi, torch.device("cpu"), torch.float32)
        got = spans.counters()["read_bytes"] - before
        # incidence and the two sigma0, plus the wind where it is the scene's own
        want = n * (12 if isinstance(wind, np.ndarray) else 12 + 8)
        assert got == want
