"""Off the GMF manifold: the port's fused path against the JAX package's
Pallas path, on the CPU.

Uniform-random sigma0 and ancillary wind (seeds 7 and 8, 2**14 pixels: the
inputs of ``chip_profile.py``'s off-GMF diagnostics) on reduced tables
(``inc_step=1.0, wspd_step=0.5, phi_step=5.0``) built on the JAX tables' own
arrays (``InversionTables.from_arrays``). Such pixels have shallow, multi-basin
cost planes, where the fused path's ``(lut - s0) * (1 / dsig)`` and the exact
path's ``(lut - s0) / dsig`` can pick different near-equal minima.

* port ``mode="fused"`` (plain kernel versions, float32) against JAX
  ``mode="pallas_interpret"``: the same winner on every pixel, NaN masks
  identical; outputs equal up to the phi = +-180 deg tie and 2**-22 relative
  (float32 sin/cos of the same winner; another winner would differ by a
  whole LUT step). So the JAX Pallas path flips the pixels the port's fused
  path flips.
* port ``mode="fused"`` against the port's ``mode="exact"``: at most 0.1% of
  pixels differ (2 of 2**14 on seed 7, none on seed 8).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

from test_torch_inversion import F32_TRIG, _port_tables, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

REDUCED = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
N = 1 << 14


@pytest.fixture(scope="module")
def tables():
    lut_co = jax_model("gmf_cmod5n").to_lut(units="dB", **REDUCED)
    lut_cr = jax_model("gmf_s1_v2").to_lut(units="dB", **REDUCED)
    jt = jinv.InversionTables(lut_co, lut_cr, dtype=jnp.float32)
    return jt, _port_tables(jt, lut_co, lut_cr, torch.float32)


def off_gmf_scene(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(18.0, 47.0, n), rng.uniform(-30.0, 0.0, n),
            rng.uniform(-40.0, -15.0, n), np.full(n, 0.1),
            rng.uniform(0.5, 25.0, n) * np.exp(1j * rng.uniform(0.0, 2 * np.pi, n)))


@pytest.mark.parametrize("seed", [7, 8])
def test_fused_matches_jax_pallas_off_the_gmf_manifold(tables, seed):
    jt, tt = tables
    args = off_gmf_scene(N, seed)
    fused = invert_pixels(tt, *args, mode="fused", device="cpu")
    ref = jinv.invert_pixels(jt, *args, mode="pallas_interpret")
    exact = invert_pixels(tt, *args, mode="exact", device="cpu")
    flipped = np.zeros(N, bool)
    for f, r, e in zip(fused, ref, exact):
        assert f.dtype == np.complex64 and np.isfinite(f).all()
        assert_parity(f, np.asarray(r), F32_TRIG)
        flipped |= ~(f == e)
    assert flipped.sum() <= N // 1000, flipped.sum()
