"""The harness on the CPU: a cell, a traffic mix and a metric added as files
alone are picked up; a run whose timed path is broken underneath comes out
not correct."""

import json
import shutil
import time

import pytest
import torch

from benchmark import harness
from benchmark.entries import host, resident
from benchmark.harness import Cell, run_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def tiny(root, name):
    cell = Cell(root, name)
    cell.traffic = dict(cell.traffic, lines=16, samples=40, pool=2)
    cell.checks = dict(cell.checks, sample_per_scene=320)
    return cell


def run(root, cell, seconds=0.05):
    return run_cell(root, cell.name, SEED, seconds, False, CPU, time.perf_counter(), cell=cell)


def test_cell_traffic_and_metric_added_as_files_are_picked_up(root, tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(root / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "benchmark" / "traffic" / "iw_100m_resident.json").read_text())
    base.update(lines=8, samples=24, pool=2)
    (copy / "benchmark" / "traffic" / "tiny_resident.json").write_text(json.dumps(base))
    shutil.copy(root / "benchmark" / "cells" / "s1_iw_resident.json",
                copy / "benchmark" / "cells" / "tiny_cell.json")
    (copy / "benchmark" / "metrics" / "scenes_per_s.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    spec["workloads"].append({"name": "tiny_cell", "config": "s1_dualpol_cmod5n_s1v2",
                              "traffic": "tiny_resident", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "scenes_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    result, lines, _ = run_cell(copy, "tiny_cell", SEED, 0.05, False, CPU, time.perf_counter())
    assert result["correct"], lines
    assert set(result["metrics"]) == {"scenes_per_s", "setup_s"}
    assert result["metrics"]["scenes_per_s"]["value"] > 0
    assert (copy / "build").is_dir() is False  # the analytic configuration unpacks nothing


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(root):
    result, lines, info = run(root, tiny(root, "s1_iw_host"))
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["metrics"]) == {"host_mpx_s", "scene_p95_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["attempted"] == len(info.run.scene_s) >= 1


def rotated(winds, deg=10.0):
    """An answer altered where it is produced: the copol direction turned."""
    co, du = winds
    turn = torch.polar(torch.tensor(1.0), torch.tensor(deg).deg2rad()).to(co.dtype)
    return co * turn, du


def half_left_out(winds):
    """Half of the scene's pixels left out, the other half's answers in
    their place."""
    co, du = (w.clone() for w in winds)
    half = co.shape[0] // 2
    co[half:2 * half], du[half:2 * half] = co[:half], du[:half]
    return co, du


def unchanged(placed):
    """A call that hands back its state unchanged: the prior wind."""
    anc = placed["anc"]
    return anc, anc


def broken_resident(fault):
    real = resident.invert

    def invert(program, placed):
        if fault is unchanged:
            return fault(placed)
        return fault(real(program, placed))

    return invert


@pytest.mark.parametrize("fault", [rotated, half_left_out, unchanged])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(resident, "invert", broken_resident(fault))
    result, lines, _ = run(root, tiny(root, "s1_iw_resident"))
    assert not result["correct"] and result["failed"] == result["attempted"], lines


def test_a_broken_host_path_is_not_correct(root, monkeypatch):
    real = host.invert

    def invert(program, placed):
        co, du = real(program, placed)
        return rotated((torch.from_numpy(co), torch.from_numpy(du)))

    def take(winds, idx):
        return winds[0].reshape(-1)[idx.cpu()], winds[1].reshape(-1)[idx.cpu()]

    monkeypatch.setattr(host, "invert", invert)
    monkeypatch.setattr(host, "take", take)
    result, lines, _ = run(root, tiny(root, "s1_iw_host"))
    assert not result["correct"], lines


def test_the_harness_names_no_cell(root):
    text = (root / "benchmark" / "harness.py").read_text()
    for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]:
        assert w["name"] not in text and w["traffic"] not in text
    assert harness.WARMUP_CALLS >= 1
