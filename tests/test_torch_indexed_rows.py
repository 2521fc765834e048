"""K1-K4 reading their feature rows through the bucket permutation, on the
CPU (the kernels' plain versions).

* each kernel through the bucket permutation (K1 staged and streamed on an
  8-float rows table read as 4, K2 on 8 floats, K3 and K4 on 4), padding
  slots and a block of NaN s0 included, equal bit for bit to the same
  kernel through the identity permutation on the slot-order copy
  ``where(perm >= 0, rows[perm.clamp(0)], nan)`` that the fused path made
  before, and K2-K4's pixel-order results equal to that copy's results
  scattered back by boolean-mask indexing; both launches count their slots
  (``perm_rows_read``);
* ``invert_pixels`` in ``fused`` and ``fused_exact`` mode, on the fused tail
  (one incidence axis: K1, K2) and the unfused one (own crosspol axis: K1,
  K3, K4), on a scene with a coastal NaN block: equal bit for bit to the
  same call with every kernel in its copying form (``_bucket_copies``).

The same checks on the card, at 2^22 + 57 px and on the cells' scenes, are
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import xsarsea_tpu_torch.models as P
from xsarsea_tpu_torch.utils import spans
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_pixels

from _bucket_copies import KERNELS, copying_kernels, kernel_case, run_both, same_bits

torch.set_num_threads(min(2, torch.get_num_threads()))

KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)


@pytest.mark.parametrize("name", KERNELS)
def test_indexed_kernel_equals_the_kernel_on_the_copied_rows(name):
    args, kwargs = kernel_case(name, 1500, "cpu", seed=KERNELS.index(name))
    perm = kwargs["index"]
    rows = next(a for a in args if torch.is_tensor(a) and a.shape[0] == 1500)
    assert (perm < 0).any() and torch.isnan(rows[:, 0]).any()  # padding slots, a coast
    before = spans.counters()
    got, ref = run_both(name, args, kwargs)
    after = spans.counters()
    assert same_bits(got, ref)
    if name in KERNELS[2:]:  # pixel order: one result a pixel
        assert got.shape[-1] == 1500
    # each launch reads its slots through an index: the permutation, the identity
    assert after["perm_rows_read"] - before["perm_rows_read"] == 2 * perm.numel()


def _tables(own_axis):
    """CMOD5.N and S1 v2 tables at coarse steps, the crosspol LUT on its own
    incidence axis (the unfused tail) or on the copol one (the fused tail)."""
    co = P.get_model("gmf_cmod5n").to_lut(units="dB", **KW)
    cr = P.get_model("gmf_s1_v2").to_lut(units="dB", **{**KW, "inc_step": 0.7 if own_axis
                                                          else KW["inc_step"]})
    c, r = co.coords, cr.coords
    return InversionTables.from_arrays(np.asarray(co.values), c["incidence"], c["wspd"],
                                       c["phi"], np.asarray(cr.values), r["incidence"],
                                       r["wspd"])


def _coastal_scene(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n).astype(np.float32)
    wspd = rng.uniform(0.5, 35.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = (-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)
             + rng.normal(0, 0.3, n)).astype(np.float32)
    s0_cr = (-35.0 + 0.6 * wspd - 0.1 * (inc - 30.0)).astype(np.float32)
    anc = ((wspd + rng.normal(0, 1.5, n)).clip(0.2)
           * np.exp(1j * np.deg2rad(phi))).astype(np.complex64)
    s0_co[1000:1600] = s0_cr[1000:1600] = np.nan  # the coast
    s0_cr[5] = np.nan
    return inc, s0_co, s0_cr, rng.uniform(0.1, 1.0, n).astype(np.float32), anc


@pytest.mark.parametrize("tail", ["fused_tail", "unfused_tail"])
@pytest.mark.parametrize("mode", ["fused", "fused_exact"])
def test_fused_modes_equal_the_copying_path(mode, tail, monkeypatch):
    tables = _tables(own_axis=tail == "unfused_tail")
    args = _coastal_scene()
    before = spans.counters()
    got = invert_pixels(tables, *args, mode=mode, device="cpu")
    after = spans.counters()
    assert after["perm_rows_read"] > before["perm_rows_read"]
    with monkeypatch.context() as m:
        copying_kernels(m)
        ref = invert_pixels(tables, *args, mode=mode, device="cpu")
    for g, r in zip(got, ref):
        assert same_bits(torch.as_tensor(g), torch.as_tensor(r))
    assert np.isnan(got[0][1000:1600]).all() and not np.isnan(got[0][:1000]).all()
