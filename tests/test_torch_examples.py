"""The port's examples (``xsarsea_tpu_torch/examples``) on the CPU.

Five of the seven examples run with ``device="cpu"`` at small sizes and
print their counterparts' headlines, each with its own gate (an RMS below
1.0 m/s, a detrended slope a fifth of the raw one, finite histograms). The
other two, whose headline numbers are held to the JAX examples' own helpers,
and the missing-card refusals are in ``tests/test_torch_scripts_examples.py``.
"""

import importlib

import pytest
import torch

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("name,size,headline", [
    ("create_hh_lut", dict(ny=16, nx=24), "HH inversion through the derived LUT"),
    ("detrend_roughness", dict(h=64, w=256), "normalized incidence slope"),
    ("gmfs_and_luts", {}, "netCDF round-trip"),
    ("multichip_batch", dict(h=32, w=48, n_scenes=2), "dual-pol RMS vs truth"),
    ("out_of_core_scene", dict(ny=64, nx=32), "banded streaks histogram"),
])
def test_example_runs_on_the_cpu(name, size, headline, capsys):
    res = importlib.import_module(f"xsarsea_tpu_torch.examples.{name}").main(device="cpu", **size)
    assert headline in capsys.readouterr().out and isinstance(res, dict)


