"""A short run of each cell on the card (skipped without one)."""

import json
import time
from pathlib import Path

import pytest

from benchmark.harness import run_cell

pytestmark = pytest.mark.cuda
SPEC = Path(__file__).resolve().parents[2] / "BENCHMARK.json"


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(SPEC.read_text())["workloads"]])
def test_a_short_run_is_correct(cuda, root, name):
    result, lines, info = run_cell(root, name, 2 ** 31 + 99, 1.0, False, cuda,
                                   time.perf_counter())
    assert result["correct"], lines
    assert not info.loaded
    assert all(v["value"] > 0 for v in result["metrics"].values())
