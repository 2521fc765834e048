"""K5, the slab sweep in three cost forms (plain PyTorch version, on the
CPU), against the JAX package's ``run_form`` (``scripts/bench_slab_forms.py``)
run in TPU interpret mode, its two loops (the shared sweep and the
one-pixel-a-thread baseline, one plain version), and its script
``xsarsea_tpu_torch.scripts.bench_slab_forms`` end to end on small tables.

The JAX script is loaded from its file; it imports its benchmark helpers
only inside ``timed``, which these tests never call. Its operands are the
pack-2 layout of ``build_direct_arrays_packed`` and the port's the unpacked
one of ``build_direct_arrays``: the flat indices do not depend on the
layout, so they are held bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from xsarsea_tpu.ops import pallas_inversion as jpi
from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.scripts import bench_slab_forms

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))

_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bench_slab_forms.py"
INV_DSIG = np.float32(1.0 / 0.1)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_bench_slab_forms", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(seed, n_inc=3, n_wspd=70, n_phi=181):
    """Slab blocks with every sentinel and tie: block 0's slab holds a NaN
    LUT entry (2**30 for all its pixels); block 1 has pixels exactly on the
    duplicated phi columns 4/5 (a cost tie: the lower column wins) and NaN
    padding rows; block 2's slab lies wholly in the padding rows (no finite
    cost); block 3's straddles the last true row; block 4 holds padding
    only (vmask 0)."""
    rng = np.random.default_rng(seed)
    wspd = np.linspace(0.2, 30, n_wspd).astype(np.float32)
    phir = np.deg2rad(np.linspace(0, 180, n_phi)).astype(np.float32)
    phir[5] = phir[4]
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    lut[:, :, 5] = lut[:, :, 4]
    lut[1, 30, 9] = np.nan
    u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np.float32)
    sband = np.array([1, 0, 2, 2, 0], np.int32)
    srow0 = np.array([16, 0, 80, 48, 0], np.int32)
    vmask = np.array([1, 1, 1, 1, 0], np.int32)
    n = sband.shape[0] * K.SLAB_BLOCK
    s0 = rng.uniform(-30, -5, n).astype(np.float32)
    ma2 = rng.uniform(-12, 12, n).astype(np.float32) * np.float32(0.5)
    mz2 = rng.uniform(0, 12, n).astype(np.float32) * np.float32(0.5)
    b1 = K.SLAB_BLOCK
    for k, (r, c) in enumerate([(19, 4), (19, 5), (3, 5), (40, 4)]):
        s0[b1 + k], ma2[b1 + k], mz2[b1 + k] = lut[0, r, c], u[r, c] * 0.5, v[r, c] * 0.5
    direct = np.stack([s0, ma2, mz2, np.full(n, INV_DSIG)], 1)
    pre = np.stack([s0 * INV_DSIG, ma2, mz2, np.ones(n, np.float32)], 1)
    for f in (direct, pre):
        f[b1 + 20:b1 + 24] = np.nan  # padding slots
        f[4 * K.SLAB_BLOCK:] = np.nan  # the all-padding block
    return dict(lut=lut, u=u, v=v, sband=sband, srow0=srow0, vmask=vmask, n_phi=n_phi,
                feats={"direct": direct, "prescaled": pre, "expanded_uv": pre})


def _jax_form(mod, form, c):
    """``run_form`` on the script's own operands (``:205-217``)."""
    lut_pk, u_pk, v_pk, _wp, lane_off = jpi.build_direct_arrays_packed(c["lut"], c["u"], c["v"])
    dummy_k = np.zeros((8, lut_pk.shape[2]), np.float32)
    ops = {"direct": (lut_pk, u_pk, v_pk, dummy_k),
           "prescaled": (lut_pk * INV_DSIG, u_pk, v_pk, dummy_k),
           "expanded_uv": (lut_pk * INV_DSIG, -2.0 * u_pk, -2.0 * v_pk,
                           u_pk * u_pk + v_pk * v_pk)}[form]
    n_sweep = K.SLAB_ROWS // 2
    with pltpu.force_tpu_interpret_mode():
        out = mod.run_form(form, *(jnp.asarray(a) for a in ops), jnp.asarray(c["feats"][form]),
                           jnp.asarray(c["sband"]), jnp.asarray(c["srow0"]),
                           jnp.asarray(c["vmask"]), c["n_phi"], K.SLAB_ROWS, n_sweep, lane_off)
    return np.asarray(out)


def _port_form(form, c):
    ops = E.build_form_arrays(form, c["lut"], c["u"], c["v"], 0.1)
    t = [None if a is None else torch.as_tensor(a) for a in ops]
    return E.slab_forms(form, *t, torch.as_tensor(c["feats"][form]),
                        *(torch.as_tensor(c[k]) for k in ("sband", "srow0", "vmask"))).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("form", E.FORMS)
def test_slab_forms_plain_bit_equal_to_run_form(jax_script, form, seed):
    c = _case(seed)
    ref = _jax_form(jax_script, form, c)
    got = _port_form(form, c)
    # expected bit-equal on every block the TPU kernel runs (it leaves vmask-0
    # blocks unwritten; the port writes 0): the same f32 op sequence per
    # entry, the same first-minimum rule and the same sentinels
    live = c["vmask"] == 1
    np.testing.assert_array_equal(got[live], ref[live])
    assert got.dtype == np.int32 and (got[~live] == 0).all()
    n_phi = c["n_phi"]
    no_hit = ((2 ** 30 // n_phi) & ~1) * n_phi
    assert (got[0] == 2 ** 30).all()  # the NaN LUT entry inside block 0's slab
    # ties go to the lowest flat index: column 4 over its duplicate 5
    np.testing.assert_array_equal(got[1, :4], [19 * n_phi + 4] * 2 + [3 * n_phi + 4,
                                                                      40 * n_phi + 4])
    assert (got[1, 20:24] == 2 ** 30).all()  # padding slots: every cost NaN
    assert (got[2] == no_hit).all()  # a slab of padding rows only
    assert got[3].max() < c["lut"].shape[1] * n_phi  # padding rows never win
    assert E.launch_counts() == {}


def test_direct_form_is_slab_refine():
    c = _case(3)
    ops = [torch.as_tensor(a) for a in E.build_form_arrays("direct", c["lut"], c["u"], c["v"],
                                                           0.1)[:3]]
    rest = [torch.as_tensor(c["feats"]["direct"])] + [torch.as_tensor(c[k]) for k in
                                                      ("sband", "srow0", "vmask")]
    index = torch.arange(rest[0].shape[0])  # K3 reads the slot-order rows through the identity
    np.testing.assert_array_equal(
        E.slab_forms("direct", *ops, None, *rest).numpy().reshape(-1),
        K._slab_refine_plain(*ops, *rest, block=K.SLAB_BLOCK, index=index).numpy())


def test_build_form_arrays():
    c = _case(0)
    lut_pad, u_half, v_half = K.build_direct_arrays(c["lut"], c["u"], c["v"])
    lut_s, u_p, v_p, kr = E.build_form_arrays("prescaled", c["lut"], c["u"], c["v"], 0.1)
    assert kr is None and np.array_equal(u_p, u_half) and np.array_equal(v_p, v_half)
    assert np.array_equal(lut_s, lut_pad * INV_DSIG, equal_nan=True)
    assert lut_s.dtype == np.float32 and (lut_s[:, c["lut"].shape[1]:] == np.float32(1e20)).all()
    lut_e, u2, v2, kr = E.build_form_arrays("expanded_uv", c["lut"], c["u"], c["v"], 0.1)
    assert np.array_equal(u2, -2 * u_half) and np.array_equal(v2, -2 * v_half)
    assert np.array_equal(kr, u_half * u_half + v_half * v_half) and kr.dtype == np.float32
    with pytest.raises(ValueError, match="unknown slab cost form"):
        E.build_form_arrays("expanded", c["lut"], c["u"], c["v"], 0.1)


def test_slab_forms_wrapper_refuses_bad_calls():
    one = torch.ones(1, dtype=torch.int32)
    ops = (torch.empty(1, 1, 1), torch.empty(1, 1), torch.empty(1, 1))
    with pytest.raises(ValueError, match="unknown slab cost form"):
        E.slab_forms("expanded", *ops, torch.empty(1, 1), torch.empty((128, 4)), one, one, one)
    with pytest.raises(ValueError, match="kr is needed"):
        E.slab_forms("expanded_uv", *ops, None, torch.empty((128, 4)), one, one, one)
    with pytest.raises(ValueError, match="kr is unused"):
        E.slab_forms("prescaled", *ops, torch.empty(1, 1), torch.empty((128, 4)), one, one, one)
    with pytest.raises(ValueError, match="device"):
        E.slab_forms("direct", *ops, None, torch.empty((128, 4), device="meta"), one, one, one)


def test_bench_slab_forms_main_on_cpu(capsys):
    E.reset_launch_counts()
    res = bench_slab_forms.main(n=2 ** 12, device="cpu", inc_step=1.0, wspd_step=0.5,
                                phi_step=5.0)
    out = capsys.readouterr().out
    assert "slab form=expanded_uv" in out and "expanded_uv: flips vs direct" in out
    forms = res["forms"]
    assert set(forms) == set(E.FORMS) and all(r["ms"] is None for r in forms.values())
    args = forms["direct"]["args"]
    slots = res["slots"]
    assert slots % K.SLAB_BLOCK == 0 and args[5].shape == (slots, 4)
    # the direct form is K3 on the same arguments
    np.testing.assert_array_equal(forms["direct"]["out"].numpy().reshape(-1),
                                  K.slab_refine(*args[1:4], *args[5:],
                                                index=torch.arange(slots)).numpy())
    for form, r in forms.items():
        assert r["out"].shape == (slots // K.SLAB_BLOCK, K.SLAB_BLOCK)
    for form, f in res["flips"].items():
        assert f["valid"] == 2 ** 12 and 0 <= f["flips"] <= f["valid"]
        assert f["better"] + f["worse"] + f["tie"] == f["flips"]
    assert E.launch_counts() == {}


def test_bench_slab_forms_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_slab_forms.main(n=2 ** 10)


@pytest.mark.parametrize("form", E.FORMS)
def test_both_loops_take_the_plain_version_on_the_cpu(form):
    """The shared sweep and the thread loop compute one function: on a CPU
    tensor both give the plain version's bits, which run_form's are."""
    c = _case(4)
    ops = [None if a is None else torch.as_tensor(a)
           for a in E.build_form_arrays(form, c["lut"], c["u"], c["v"], 0.1)]
    rest = [torch.as_tensor(c["feats"][form])] + [torch.as_tensor(c[k]) for k in
                                                  ("sband", "srow0", "vmask")]
    ref = E._slab_forms_plain(form, *ops, *rest)
    for loop in E.LOOPS:
        assert torch.equal(E.slab_forms(form, *ops, *rest, loop=loop), ref)
    assert E.launch_counts() == {}


def test_slab_forms_refuses_an_unknown_loop():
    one = torch.ones(1, dtype=torch.int32)
    ops = (torch.empty(1, 1, 1), torch.empty(1, 1), torch.empty(1, 1))
    with pytest.raises(ValueError, match="unknown slab loop"):
        E.slab_forms("direct", *ops, None, torch.empty((128, 4)), one, one, one, loop="warp")
    with pytest.raises(ValueError, match="unknown slab loop"):
        E.slab_forms("direct", *ops, None, torch.empty((128, 4)), one, one, one, loop=None)


def test_bench_slab_forms_main_reports_both_loops(capsys):
    res = bench_slab_forms.main(n=2 ** 11, device="cpu", inc_step=1.0, wspd_step=0.5,
                                phi_step=5.0)
    out = capsys.readouterr().out
    for form in E.FORMS:
        for loop in E.LOOPS:
            assert f"slab form={form:12s} loop={loop:6s}" in out
        assert f"slab form={form:12s} loops bit-equal: True" in out
        r = res["forms"][form]
        assert r["thread"]["ms"] is None and torch.equal(r["thread"]["out"], r["out"])
    assert E.launch_counts() == {}
