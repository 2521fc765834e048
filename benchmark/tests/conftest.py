"""Tests of the benchmark: ``python -m pytest benchmark/tests -q`` from the
root of the checkout. They run on the CPU; those marked ``cuda`` need a card
and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def root():
    return ROOT
