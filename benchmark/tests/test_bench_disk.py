"""The disk-fed cell on the CPU: a tiny ``s1_ew_disk`` run is correct and
reports its end-to-end metrics, a rotated answer from ``disk.invert`` is not,
no scene directory outlives its arrays or a process that failed, and the
lanes' wait readers read the union of their spans, None without spans."""

import gc
import subprocess
import sys
import textwrap
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.entries import disk

from test_bench_harness import rotated, run, tiny
from test_bench_spans import annotations, reader, traced


def _scenes():
    return set(disk.SCENES.iterdir()) if disk.SCENES.is_dir() else set()


def test_a_tiny_disk_run_is_correct_and_leaves_no_scene(root):
    before = _scenes()
    result, lines, info = run(root, tiny(root, "s1_ew_disk"))
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["metrics"]) == {"host_mpx_s", "setup_s"}
    assert result["attempted"] == len(info.run.scene_s) >= 1
    gc.collect()
    assert _scenes() <= before


def test_place_writes_the_files_and_maps_them_back(root):
    before = _scenes()
    n = 6 * 7
    f64 = dict(dtype=torch.float64)
    scene = {"shape": (6, 7), "inc": torch.linspace(19.0, 47.0, n, **f64),
             "s0_co": torch.rand(n, **f64), "s0_cr": torch.rand(n, **f64) * 1e-3,
             "dsig_cr": torch.rand(n, **f64), "anc_re": torch.randn(n, **f64),
             "anc_im": torch.randn(n, **f64)}
    scene["s0_co"][3] = float("nan")
    placed = disk.place(scene)
    path = placed.path
    assert path.parent == disk.SCENES and path.is_dir()
    assert sorted(p.name for p in path.iterdir()) == sorted(f"{k}.npy" for k, _ in disk.FILES)
    want = {"inc": np.float32, "s0_co": np.float32, "s0_cr": np.float32,
            "dsig_cr": np.float32, "anc": np.complex64}
    mapped = disk.open_scene(placed)
    for k, dtype in want.items():
        a = mapped[k]
        assert isinstance(a, np.memmap) and a.dtype == dtype and a.shape == (6, 7)
        assert not a.flags.writeable
    np.testing.assert_array_equal(mapped["s0_co"].reshape(-1), scene["s0_co"].float().numpy())
    np.testing.assert_array_equal(mapped["anc"].reshape(-1).imag,
                                  scene["anc_im"].float().numpy())
    del mapped
    del placed
    gc.collect()
    assert not path.exists() and _scenes() <= before


def test_each_call_maps_the_files_anew_and_drops_them():
    """A call reads the scene through maps of its own, opened for the call and
    gone when it returns, as a chain opens each product: no page of the files
    stays mapped between calls."""
    n = 4 * 5
    scene = {"shape": (4, 5), **{k: torch.rand(n, dtype=torch.float64) for k in
             ("inc", "s0_co", "s0_cr", "dsig_cr", "anc_re", "anc_im")}}
    placed = disk.place(scene)
    seen = []

    class Program:
        dsig_co, models, dtype, mode, device = 0.1, ("a", "b"), torch.float32, "fused", "cpu"

        def invert_from_model(self, inc, s0_co, s0_cr, ancillary_wind, dsig_cr, **kw):
            arrays = (inc, s0_co, s0_cr, ancillary_wind, dsig_cr)
            assert all(isinstance(a, np.memmap) for a in arrays)
            assert {Path(a.filename).parent for a in arrays} == {placed.path}
            seen.append([weakref.ref(a) for a in arrays])
            return np.zeros(scene["shape"], np.complex64), np.zeros(scene["shape"], np.complex64)

    for _ in range(2):
        disk.invert(Program(), placed)
        gc.collect()
        assert all(r() is None for r in seen[-1])
    assert len(seen) == 2 and not {id(r) for r in seen[0]} & {id(r) for r in seen[1]}


def test_a_rotated_answer_from_disk_is_not_correct(root, monkeypatch):
    real = disk.invert

    def invert(program, placed):
        co, du = real(program, placed)
        return rotated((torch.from_numpy(co), torch.from_numpy(du)))

    def take(winds, idx):
        return winds[0].reshape(-1)[idx.cpu()], winds[1].reshape(-1)[idx.cpu()]

    monkeypatch.setattr(disk, "invert", invert)
    monkeypatch.setattr(disk, "take", take)
    result, lines, _ = run(root, tiny(root, "s1_ew_disk"))
    assert not result["correct"] and result["failed"] == result["attempted"], lines


def test_a_run_that_raises_leaves_no_scene(root, monkeypatch):
    before = _scenes()

    def fails(program, placed):
        raise RuntimeError("the program failed")

    monkeypatch.setattr(disk, "invert", fails)
    with pytest.raises(RuntimeError, match="the program failed"):
        run(root, tiny(root, "s1_ew_disk"))
    gc.collect()
    assert _scenes() <= before


def test_a_process_that_fails_with_scenes_placed_leaves_none(root):
    """The scene's arrays still held when the process dies of an error: the
    entry's finalizer removes the directory at exit."""
    before = _scenes()
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(root)!r})
        import torch
        from benchmark.entries import disk
        n = 12
        scene = {{"shape": (3, 4), **{{k: torch.rand(n, dtype=torch.float64) for k in
                 ("inc", "s0_co", "s0_cr", "dsig_cr", "anc_re", "anc_im")}}}}
        held = [disk.place(scene), disk.place(scene)]
        print(held[0].path, flush=True)
        raise SystemExit("failed with two scenes placed")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "failed with two scenes placed" in out.stderr
    assert out.stdout.strip().startswith(str(disk.SCENES))
    assert _scenes() <= before


@pytest.mark.parametrize("metric,span", [("prep_wait_ms_per_mpx", "xs.wait.prep"),
                                         ("drain_wait_ms_per_mpx", "xs.wait.drain")])
def test_lane_wait_readers(root, metric, span):
    read = reader(root, metric)
    assert read(traced(annotations(("benchmark.scene", 0, 900)))) is None  # no xs.* span
    assert read(traced([])) is None
    # two overlapping waits (100-250) and one apart (400-450), the other lane's
    # wait and a span outside the window left out: 200 us over 2 Mpx
    other = "xs.wait.drain" if span == "xs.wait.prep" else "xs.wait.prep"
    run_ = traced(annotations(("xs.call", 0, 990), (span, 100, 100), (span, 150, 100),
                              (span, 400, 50), (other, 600, 300), (span, 2000, 50)))
    assert read(run_) == pytest.approx(0.2 / 2)
    assert read(traced(annotations(("xs.call", 0, 990)))) == 0.0
