"""The port's new scripts and examples against the JAX package's, on the CPU.

* ``scripts/demo_full_scene.build_scene`` at 2**16 px (nx 256) against the
  JAX script's: the host draws (incidence, true speed, ancillary wind)
  bit-equal. The port evaluates the GMFs with all three inputs in float64;
  so does the JAX package's GMF on the same draws, to rtol 1e-10
  (``tests/test_torch_gmfs.py``'s tolerance), which the float32 store
  leaves at one float32 ulp (rtol 2**-23). The JAX script hands its GMF the
  float32 speed and direction arrays, which JAX raises to float64 only where
  they meet the float64 incidence: its stored sigma0 agree with the port's to
  rtol 1e-6 (a few float32 roundings; 2.3e-7 at most here);
* the four stage and scaling scripts at small sizes with ``device="cpu"``:
  each runs its plain paths and prints its rows (``bench_stages`` also holds
  its stages to the production closure bit for bit);
* two of the seven examples with ``device="cpu"`` at small sizes (the other
  five: ``tests/test_torch_examples.py``): ``windspeed_retrieval``'s RMS
  equals, to rtol 1e-9, the same computation through the JAX example's own
  ``make_scene`` and ``multilook`` and the JAX package (the GMFs' 1e-10
  becomes ~1e-13 in the RMS unless an argmin flips); ``streaks_direction``'s
  retrieved direction equals the one the JAX package finds on the JAX
  example's ``streak_image`` (the same bin);
* without a card, each example's ``main()`` and the demo raise, naming the
  device.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from xsarsea_tpu.dimarray import DimArray as JDimArray
from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.gradients import Gradients as JGradients, circ_smooth as jcirc_smooth
from xsarsea_tpu.windspeed import get_dsig as jget_dsig, invert_from_model as jinvert, \
    nesz_flattening as jnesz_flattening
from xsarsea_tpu_torch.scripts import (bench_gather_sizes, bench_scaling, bench_stages,
                                       bench_streaks_stages, demo_full_scene)

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_TABLES = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
EXAMPLES = ("create_hh_lut", "detrend_roughness", "gmfs_and_luts", "multichip_batch",
            "out_of_core_scene", "streaks_direction", "windspeed_retrieval")


def load_jax_file(relpath, name):
    """A JAX-package script or example, loaded from its file (neither
    directory is a package); importing one runs nothing."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_build_scene_matches_jax(tmp_path):
    jdemo = load_jax_file("scripts/demo_full_scene.py", "jax_demo_full_scene")
    n, nx = 1 << 16, 256
    shape = (n // nx, nx)
    assert jdemo.build_scene(str(tmp_path / "jax"), n, nx=nx) == shape
    assert demo_full_scene.build_scene(str(tmp_path / "port"), n, nx=nx, device="cpu") == shape
    # the draws of one band (2**16 px is one), replayed in float64
    rng = np.random.default_rng(0)
    wspd = rng.uniform(0.5, 45.0, shape).astype(np.float32)
    phi = rng.uniform(-180.0, 180.0, shape).astype(np.float32)
    inc = np.linspace(19.0, 47.0, nx, dtype=np.float32)[None, :] + rng.normal(0, 0.02, shape)
    f64 = (inc, wspd.astype(np.float64), np.abs(phi).astype(np.float64))
    gmf64 = {"s0_co": np.asarray(jax_model("gmf_cmod5n")._gmf_fn(*f64)),
             "s0_cr": np.asarray(jax_model("gmf_s1_v2")._gmf_fn(*f64[:2]))}
    for key, dtype in demo_full_scene.KEYS:
        ref = np.load(tmp_path / "jax" / f"{key}.npy")
        got = np.load(tmp_path / "port" / f"{key}.npy")
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape == shape
        if key in gmf64:
            np.testing.assert_allclose(got, gmf64[key].astype(np.float32), rtol=2.0 ** -23,
                                       atol=0, err_msg=key)
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=key)


def test_demo_inverts_a_small_scene_from_disk(tmp_path, capsys):
    d = str(tmp_path / "scene")
    demo_full_scene.build_scene(d, 256, nx=64, device="cpu")
    res = demo_full_scene.main(["--dir", d, "--skip-build", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "inverted" in out and "python-allocated peak" in out and "RMS vs truth" in out
    assert res["px"] == 256 and np.isfinite(res["rms"]) and res["rms"] < 1.0
    assert res["output_bytes"] == 2 * 16 * 256  # two complex128 scenes on the CPU


def test_bench_stages_cpu(capsys):
    res = bench_stages.main(n=1 << 12, device="cpu", reps=1, table_kwargs=SMALL_TABLES)
    out = capsys.readouterr().out
    assert [name for name, _ in res["stages"]] == [
        "1 bucket by incidence", "2 features + gather pix[perm]", "3 K1 group_argmin",
        "4 rebucket (band, group)", "5 gather pix[perm2]", "6 K2 slab_refine_fused",
        "7 scatter to pixel order + postprocess"]
    assert "sum of stages" in out and "whole call" in out and "ns/px" in out
    assert res["sum_ms"] == pytest.approx(sum(ms for _, ms in res["stages"]))


def test_bench_streaks_stages_cpu(capsys):
    res = bench_streaks_stages.main(side=512, device="cpu", reps=1)
    out = capsys.readouterr().out
    assert len(res["stages"]) == 11 and res["px"] == 512 * 512
    assert "D3 index_add_ binning alone" in out and "Mpx/s" in out


def test_bench_gather_sizes_cpu(capsys):
    res = bench_gather_sizes.main(n=1 << 12, device="cpu", reps=1)
    out = capsys.readouterr().out
    assert len(res["rows"]) == 7 and all(ms > 0 for _, ms in res["rows"])
    assert "shipped stage 3" in out and "ns/px" in out


def test_bench_scaling_cpu(capsys):
    res = bench_scaling.main(n=1 << 12, device="cpu", counts=(1, 2, 4))
    out = capsys.readouterr().out
    assert [r["entries"] for r in res["weak"]] == [1, 2, 4]
    assert [r["px"] for r in res["weak"]] == [128, 256, 512]
    for work in res["balance"].values():
        assert len(work) == 8 and min(work) > 0
    assert "| entries |" in out and "imbalance=" in out


def _example(name):
    return importlib.import_module(f"xsarsea_tpu_torch.examples.{name}")


def test_windspeed_retrieval_rms_matches_jax(capsys):
    jex = load_jax_file("examples/windspeed_retrieval.py", "jax_windspeed_retrieval")
    h = w = 64
    res = _example("windspeed_retrieval").main(device="cpu", h=h, w=w)
    assert "dual-pol retrieval: speed RMS vs truth" in capsys.readouterr().out

    inc, s0_co, s0_cr, nesz_cr, anc, wspd_true, _ = jex.make_scene(h, w)
    ml = jex.multilook
    inc, s0_co, s0_cr, nesz_cr, anc, wspd_true = (ml(a) for a in (inc, s0_co, s0_cr, nesz_cr,
                                                                   anc, wspd_true))
    noise_flat = jnesz_flattening(nesz_cr, JDimArray(inc, dims=("line", "sample")))
    dsig_cr = jget_dsig("gmf_s1_v2", inc, s0_cr, np.asarray(noise_flat))
    _, wind_dual = jinvert(inc, s0_co, np.clip(s0_cr - nesz_cr, 1e-15, None),
                           ancillary_wind=anc, dsig_cr=dsig_cr,
                           model=("gmf_cmod5n", "gmf_s1_v2"))
    speed = np.abs(np.asarray(wind_dual))
    ok = ~np.isnan(speed)
    rms = np.sqrt(np.mean((speed[ok] - wspd_true[ok]) ** 2))
    assert res["rms"] == pytest.approx(rms, rel=1e-9) and res["rms"] < 1.0
    assert res["valid"] == ok.mean()


def test_streaks_direction_matches_jax(capsys):
    jex = load_jax_file("examples/streaks_direction.py", "jax_streaks_direction")
    h = w = 256
    res = _example("streaks_direction").main(device="cpu", h=h, w=w)
    assert "streak direction: truth 25 deg" in capsys.readouterr().out

    img = jex.streak_image(h, w, 25.0)
    da = JDimArray(img[None], dims=("pol", "line", "sample"),
                   coords={"pol": np.array(["VV"]), "line": np.arange(h), "sample": np.arange(w)})
    hist = JGradients(da, windows_sizes=[160], downscales_factors=[1, 2]).histogram
    weight = jcirc_smooth(hist["weight"].mean(dim=["downscale_factor", "window_size", "pol"]))
    angles = np.asarray(weight.coords["angles"])
    peak = np.rad2deg(angles[int(np.argmax(np.asarray(weight.data).mean(axis=(0, 1))))]) + 90.0
    assert res["peak"] == peak and abs(res["err"]) < 7.5


def test_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in EXAMPLES:
        with pytest.raises(RuntimeError, match="'cuda'"):
            _example(name).main()
    with pytest.raises(RuntimeError, match="'cuda'"):
        demo_full_scene.main(["--px", "1024", "--dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
