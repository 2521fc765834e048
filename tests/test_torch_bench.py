"""The port's benchmark (``xsarsea_tpu_torch/bench.py``) on the CPU, at small
sizes, against the JAX package's ``bench.py`` (loaded from its file: its top
level only reads the clock) and its ``exact`` inversion.

The scene's draws are bit-equal to ``bench.py:446-461``'s and its sigma0 equal
to the JAX package's GMFs to rtol 1e-10 (``tests/test_torch_gmfs.py``'s
tolerance); the synthetic CMOD7 file equals the JAX bench's byte for byte but
for float32 values one ulp apart (the two libraries' GMFs differ in the last
f64 ulps); one run of ``main(device="cpu")`` on 2**14 px, with every LUT at
1 deg x 1 m/s x 10 deg, gives every key of the record and a speed RMS within
1e-3 m/s of the JAX ``exact`` inversion's on the JAX scene. A failed section,
a signal and a missing card make the bench fail loudly.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsarsea_tpu_torch
from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.models.base import Model as JModel
from xsarsea_tpu.windspeed.inversion import invert_pixels as jax_invert_pixels
from xsarsea_tpu.windspeed.inversion import prepare_tables as jax_prepare_tables
from xsarsea_tpu_torch import bench
from xsarsea_tpu_torch.models import cmod7
from xsarsea_tpu_torch.models.base import Model
from xsarsea_tpu_torch.windspeed import inversion as inv

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = Path(__file__).resolve().parents[1]
N = 1 << 14
STEPS = dict(inc_step=1.0, wspd_step=1.0, phi_step=10.0)
SIZES = dict(tile=512, class_side=512, detrend_shape=(256, 128), lut_steps=STEPS)
RTOL_GMF = 1e-10
RMS_TOL = 1e-3  # m/s: the f32 tables' argmin on two libraries' sigma0
RECORD_KEYS = {
    "value", "unit", "backend", "mode", "card", "launches", "rms_vs_truth_noisy_m_s",
    "cmod7_mpx_s", "copol_mpx_s", "cuda_vs_exact_max_dev_m_s", "streaks_mpx_s",
    "gradients_class_mpx_s", "detrend_mpx_s", "e2e_from_host_mpx_s", "e2e_disk_mpx_s",
    "host_prep_mpx_s", "e2e_from_host_fresh_mpx_s", "e2e_fresh_first_pass_s", "native_lutio",
    "native_cmod7_decode_bit_equal"}
SECTIONS = {"native_lutio", "detrend", "headline", "cmod7", "copol", "parity", "streaks",
            "gradients_class", "e2e_from_host", "e2e_disk", "host_prep", "e2e_fresh"}


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_draws(n):
    """``bench.py:446-449`` and ``:460-461``, transcribed."""
    rng = np.random.default_rng(0)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    return inc, wspd, phi, anc


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _build_codec(out_dir):
    """The port's codec built with g++ from the checkout's source, as
    ``setup.py build_ext --inplace`` builds it, without writing into the
    checkout."""
    out = out_dir / ("_lutio" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
                    str(ROOT / "xsarsea_tpu_torch" / "native" / "lutio.cpp"), "-o", str(out)],
                   check=True, capture_output=True, timeout=240)
    spec = importlib.util.spec_from_file_location("xsarsea_tpu_torch._lutio", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _isolated(mp):
    """The port's registry as a copy, and no cached tables afterwards, so that
    no other test sees the bench's ``gmf_cmod7``."""
    mp.setattr(Model, "_available_models", dict(Model._available_models))
    try:
        yield
    finally:
        inv._cached_tables.cache_clear()


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """(exit code, record) of one ``main(device="cpu")`` on 2**14 px, with the
    native codec importable."""
    codec = _build_codec(tmp_path_factory.mktemp("lutio"))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, _isolated(mp):
        mp.setitem(sys.modules, "xsarsea_tpu_torch._lutio", codec)
        mp.setattr(xsarsea_tpu_torch, "_lutio", codec, raising=False)
        mp.delenv("BENCH_BUDGET_S", raising=False)
        with contextlib.redirect_stdout(out):
            rc = bench.main(device="cpu", n=N, **SIZES)
    return rc, _last_json(out.getvalue())


def test_make_scene_matches_jax_bench():
    sc = bench.make_scene(N, 0, device="cpu")
    inc, wspd, phi, anc = _jax_draws(N)
    for key, want in (("inc", inc), ("wspd", wspd), ("phi", phi), ("anc", anc)):
        np.testing.assert_array_equal(sc[key], want)
    np.testing.assert_array_equal(sc["dsig_cr"], np.full(N, 0.1))
    s0_co = np.asarray(jax_model("gmf_cmod5n")(inc, wspd, phi, broadcast=True))
    s0_cr = np.asarray(jax_model("gmf_s1_v2")(inc, wspd, broadcast=True))
    np.testing.assert_allclose(sc["s0_co"], s0_co, rtol=RTOL_GMF, atol=0)
    np.testing.assert_allclose(sc["s0_cr"], s0_cr, rtol=RTOL_GMF, atol=0)
    np.testing.assert_array_equal(sc["s0_co_db"], 10 * np.log10(sc["s0_co"] + 1e-15))
    np.testing.assert_array_equal(sc["s0_cr_lin32"], np.power(10.0, sc["s0_cr_db"] / 10.0)
                                  .astype(np.float32))


def test_synthetic_cmod7_matches_jax_bench(monkeypatch):
    made = []
    mkdtemp = tempfile.mkdtemp

    def recording(*args, **kwargs):
        made.append(mkdtemp(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", recording)
    # the JAX bench writes only when its registry has no gmf_cmod7; what it
    # registers goes with the copy
    monkeypatch.setattr(JModel, "_available_models",
                        {k: v for k, v in JModel._available_models.items() if k != "gmf_cmod7"})
    try:
        port_dir = bench.write_synthetic_cmod7()
        _jax_bench()._register_synthetic_cmod7()
        assert len(made) == 2 and port_dir.parent == Path(made[0])
        got = (port_dir / cmod7.TABLE_FILE).read_bytes()
        ref = (Path(made[1]) / "cmod7" / cmod7.TABLE_FILE).read_bytes()
    finally:
        for d in made:
            shutil.rmtree(d, ignore_errors=True)
    assert len(got) == len(ref) == 4 * (250 * 73 * 51 + 2)
    g, r = np.frombuffer(got, "<f4"), np.frombuffer(ref, "<f4")
    assert g[0] == r[0] == 0 and g[-1] == r[-1] == 0
    ulps = np.abs(g.view("<i4").astype(np.int64) - r.view("<i4").astype(np.int64))
    print(f"{int((ulps > 0).sum())} of {g.size} float32 values differ, by at most "
          f"{int(ulps.max())} ulp")
    assert (g > 0).sum() == g.size - 2 and ulps.max() <= 1


def test_cpu_record_has_every_key(cpu_run):
    rc, rec = cpu_run
    assert rc == 0, rec
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert "skipped_sections" not in rec and "failed_sections" not in rec
    assert rec["mode"] == "exact" and rec["backend"] == "cpu" and rec["card"] is None
    assert rec["unit"] == "Mpx/s" and rec["px"] == N
    assert rec["native_lutio"] is True and rec["native_cmod7_decode_bit_equal"] is True
    assert rec["cuda_vs_exact_max_dev_m_s"] == 0.0
    rates = [k for k in rec if k.endswith("_mpx_s")] + ["value", "e2e_fresh_first_pass_s"]
    assert all(np.isfinite(rec[k]) and rec[k] > 0 for k in rates), {k: rec[k] for k in rates}
    # no kernel launches on the CPU: the plain versions ran
    assert set(rec["launches"]) == SECTIONS and not any(rec["launches"].values())


def test_cpu_rms_matches_jax_exact(cpu_run):
    inc, wspd, phi, anc = _jax_draws(N)
    m_co, m_cr = jax_model("gmf_cmod5n"), jax_model("gmf_s1_v2")
    s0_co_db = 10 * np.log10(np.asarray(m_co(inc, wspd, phi, broadcast=True)) + 1e-15)
    s0_cr_db = 10 * np.log10(np.asarray(m_cr(inc, wspd, broadcast=True)) + 1e-15)
    tables = jax_prepare_tables(m_co, m_cr, dtype=jnp.float32, **STEPS)
    _, dual = jax_invert_pixels(tables, inc, s0_co_db, s0_cr_db, np.full(N, 0.1), anc,
                                mode="exact")
    rms = float(np.sqrt(np.nanmean((np.abs(dual) - wspd) ** 2)))
    got = cpu_run[1]["rms_vs_truth_noisy_m_s"]
    print(f"rms_vs_truth_noisy_m_s: port {got}, JAX exact {rms}")
    assert abs(got - rms) <= RMS_TOL


def test_failed_section_prints_record_and_exits_nonzero(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(bench, "_get_invert_fn", broken)
    monkeypatch.setenv("BENCH_BUDGET_S", "0")  # every section but the headline is skipped
    with pytest.MonkeyPatch.context() as mp, _isolated(mp):
        rc = bench.main(device="cpu", n=1 << 10, **SIZES)
    rec = _last_json(capsys.readouterr().out)
    assert rc == 1
    assert rec["failed_sections"] == ["headline (RuntimeError: broken on purpose)"]
    assert rec["value"] is None and rec["mode"] == "exact"
    assert {s.split()[0] for s in rec["skipped_sections"]} == SECTIONS - {"headline"}


def test_signal_prints_partial_record_and_exits_128_plus_n(monkeypatch, capsys, tmp_path):
    record = bench.Record(460)
    record.results["headline_mpx_s"] = 1.5
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    record.children.append(child)
    scratch = tmp_path / "scene"
    scratch.mkdir()
    record.tmpdirs.append(str(scratch))

    def exit_(code):
        raise SystemExit(code)

    monkeypatch.setattr(os, "_exit", exit_)
    try:
        with pytest.raises(SystemExit) as stop:
            record.on_signal(signal.SIGTERM, None)
    finally:
        child.kill()
    assert stop.value.code == 128 + signal.SIGTERM
    assert child.wait(timeout=10) == -signal.SIGKILL and not scratch.exists()
    rec = _last_json(capsys.readouterr().out)
    assert rec["value"] == 1.5
    assert rec["failed_sections"] == [f"interrupted_by_signal_{int(signal.SIGTERM)}"]


def test_default_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="'cuda'"):
        bench.main()
    with pytest.raises(RuntimeError, match="'cuda'"):
        bench.cli(["--e2e-child", str(tmp_path)])


def test_e2e_child_on_cpu(tmp_path):
    bench.write_scene_dir(str(tmp_path), bench.make_scene(N, 0, device="cpu"), STEPS)
    proc = subprocess.run([sys.executable, "-m", "xsarsea_tpu_torch.bench", "--e2e-child",
                           str(tmp_path), "--device", "cpu"], cwd=ROOT, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = _last_json(proc.stdout)
    assert np.isfinite(out["e2e_mpx_s"]) and out["e2e_mpx_s"] > 0
    assert out["first_pass_s"] > 0 and out["launches"] == {}
