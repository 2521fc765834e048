"""The kernels' range guards: what the fused closure builds lies in the
ranges the guards ask for, and it marks it so (``K.mark_in_range``), so that
its launches read nothing back; every index that no maker marked is read
back and checked, and a value out of range raises ``ValueError``. On the
CPU, where the guards run before the plain versions. Imports no JAX."""

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.utils import spans
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_pixels

from _bucket_copies import kernel_case

torch.set_num_threads(min(2, torch.get_num_threads()))

_STEPS = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)


def _tables(cross_axis):
    """CMOD5.N with the S1 v2 crosspol GMF on its incidence axis (the fused
    tail) or on one of its own (the unfused tail)."""
    cr_steps = {**_STEPS, "inc_step": 0.7} if cross_axis == "own" else _STEPS
    return InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **_STEPS),
                           get_model("gmf_s1_v2").to_lut(units="dB", **cr_steps))


def _scene(n, seed):
    """A random scene that reaches the grids' edges: incidences beyond the
    LUT's at both ends, NaN and infinite ones, NaN and off-GMF sigma0,
    calm and storm-force priors."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(10.0, 65.0, n)
    speed = rng.uniform(0.2, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 * np.log10(get_model("gmf_cmod5n")(np.clip(inc, 17, 50), speed, phi,
                                                  broadcast=True).numpy() + 1e-15)
    s0_cr = 10 * np.log10(get_model("gmf_s1_v2")(np.clip(inc, 17, 50), speed,
                                                 broadcast=True).numpy() + 1e-15)
    s0_co += rng.normal(0, 0.5, n)
    s0_co[rng.random(n) < 0.05] = rng.uniform(-60, 10)
    anc = (speed + rng.normal(0, 2, n)).clip(0.0) * np.exp(1j * np.deg2rad(phi))
    anc[:50] = 60.0
    inc[[3, 9]], inc[11], inc[12] = np.nan, np.inf, -np.inf
    s0_co[rng.random(n) < 0.1] = np.nan
    return inc, s0_co, s0_cr, np.full(n, 0.3), anc


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode,cross_axis", [("fused", "shared"), ("fused", "own"),
                                             ("fused_exact", "shared")])
def test_closure_builds_its_guarded_indices_in_range(mode, cross_axis, seed, monkeypatch):
    """The closure's ``band_of_block``, ``sband``, ``srow0`` and ``band3``
    lie in the guards' ranges and carry marks that cover them: every launch
    of a 3-piece call is waived (K1 and K2 a piece, or K1, K3 and K4) and
    none reads back."""
    tables = _tables(cross_axis)
    guards = []
    check = K._check_ranges
    monkeypatch.setattr(K, "_check_ranges", lambda *g: guards.append(g) or check(*g))
    before = spans.counters()
    invert_pixels(tables, *_scene(3000, seed), mode=mode, device="cpu", piece_size=1024)
    after = spans.counters()
    per_piece = [("band_of_block",), ("sband", "srow0")]
    if cross_axis == "own":
        per_piece.append(("band_of_block",))
    assert [tuple(g[3] for g in launch) for launch in guards] == per_piece * 3
    for launch in guards:
        for index, lo, hi, name in launch:
            assert K._marked_in(index, lo, hi), name
            assert lo <= int(index.min()) and int(index.max()) < hi, name
    assert after["range_checks"] == before["range_checks"]
    assert after["range_checks_waived"] - before["range_checks_waived"] == 3 * len(per_piece)


_GUARDED = {"group_argmin": (-2,), "group_argmin_streamed": (-2,), "slab_refine_fused": (-3, -2),
            "slab_refine": (-3, -2), "crosspol_argmin": (-1,)}


@pytest.mark.parametrize("name", sorted(_GUARDED))
def test_direct_calls_read_back_their_indices_and_refuse_out_of_range(name):
    """A direct call's indices are read back, one wait a launch, and an
    index past its range raises; marked indices are waived until they change
    in place, and a mark wider than the guard's range covers nothing."""
    args, kw = kernel_case(name, 600, "cpu")
    fn = getattr(K, name)
    n_inc, wp = args[0].shape[:2]
    top = {-1: n_inc, -2: n_inc, -3: n_inc}
    if len(_GUARDED[name]) == 2:  # K2/K3: sband, then srow0
        top[-2] = wp - K.SLAB_ROWS + 1

    def call_with(pos, index):
        a = list(args)
        a[pos] = index
        return fn(*a, **kw)

    before = spans.counters()
    fn(*args, **kw)
    for pos in _GUARDED[name]:
        bad = args[pos].clone()
        bad[0] = top[pos]
        with pytest.raises(ValueError, match="sband|srow0|band_of_block"):
            call_with(pos, bad)
        wide = K.mark_in_range(bad.clone(), 0, top[pos] + 1)
        with pytest.raises(ValueError, match="outside"):
            call_with(pos, wide)
        changed = K.mark_in_range(args[pos].clone(), 0, top[pos])
        changed[0] = top[pos]
        with pytest.raises(ValueError, match="outside"):
            call_with(pos, changed)
    marked = [K.mark_in_range(args[pos].clone(), 0, top[pos]) for pos in _GUARDED[name]]
    a = list(args)
    for pos, index in zip(_GUARDED[name], marked):
        a[pos] = index
    fn(*a, **kw)
    after = spans.counters()
    assert after["range_checks"] - before["range_checks"] == 1 + 3 * len(_GUARDED[name])
    assert after["range_checks_waived"] - before["range_checks_waived"] == 1
