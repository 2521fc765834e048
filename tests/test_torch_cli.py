"""The port's CLI (``xsarsea-tpu-torch``) against the JAX package's, on the CPU.

Ports ``tests/test_io_cli.py:89-187``. ``invert`` runs ``--device cpu --mode
exact`` (float64), JAX's ``--mode exact`` on the same scene file: the winds
are held to the tolerance ``tests/test_torch_inversion.py`` holds
``invert_from_model`` to, bit-equal up to the phi = +-180 deg tie and a
1e-13 relative slack where only torch's and XLA's atan2/sin/cos could differ.
``list`` names the same built-in models with the same pols. The LUT exports
run with the registry cut down to the sarwing pickle LUTs of
``tests/data/sarwing_luts``: each file one package writes, the other reads
with equal arrays and attrs.
"""

import os

import numpy as np
import pytest
import torch

import xsarsea_tpu.cli as jcli
import xsarsea_tpu.models as J
from xsarsea_tpu.io import lut_io as jio
import xsarsea_tpu_torch.cli as pcli
import xsarsea_tpu_torch.models as P
from xsarsea_tpu_torch.io import lut_io as pio

from test_inversion import synthetic_scene

torch.set_num_threads(min(2, torch.get_num_threads()))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
F64_TRIG = 1e-13  # tests/test_torch_inversion.py's slack for float64 trig ulps
DUAL = "gmf_cmod5n,gmf_s1_v2"


def assert_parity(got, ref, rel=F64_TRIG):
    """Equal up to the phi = +-180 deg tie and a relative slack ``rel``."""
    got, ref = np.asarray(got), np.asarray(ref)
    mask = ~np.isnan(np.abs(ref))
    np.testing.assert_array_equal(np.isnan(np.abs(got)), ~mask)
    g, r = got[mask], ref[mask]
    tie = (np.abs(g - np.conj(r)) <= rel * np.abs(r)) & (np.abs(r.imag) < 1e-4)
    np.testing.assert_allclose(np.where(tie, np.conj(g), g), r, rtol=rel, atol=0)


def run_both(tmp_path, scene, model):
    jout, pout = tmp_path / "jax.npz", tmp_path / "port.npz"
    jcli.main(["invert", str(scene), str(jout), "--model", model, "--mode", "exact"])
    pcli.main(["invert", str(scene), str(pout), "--model", model, "--mode", "exact",
               "--device", "cpu"])
    return np.load(jout), np.load(pout)


def test_cli_invert_dual_and_mono_match_jax(tmp_path, capsys):
    inc, s0_co, s0_cr, _, anc = synthetic_scene(ny=12, nx=14)
    scene = tmp_path / "scene.npz"
    np.savez(scene, inc=inc, sigma0=s0_co, sigma0_dual=s0_cr, ancillary_wind=anc)
    ref, got = run_both(tmp_path, scene, DUAL)
    for key in ("wind_co", "wind_dual"):
        assert got[key].dtype == np.complex128 and got[key].shape == inc.shape
        assert_parity(got[key], ref[key])
    out = capsys.readouterr().out
    assert "inverted 168 px with gmf_cmod5n+gmf_s1_v2" in out and "valid" in out

    mono = tmp_path / "mono.npz"
    np.savez(mono, inc=inc, sigma0=s0_co, ancillary_wind=anc)
    ref, got = run_both(tmp_path, mono, "gmf_cmod5n")
    assert list(got.keys()) == ["wind"]
    assert_parity(got["wind"], ref["wind"])


def test_cli_invert_directory_memmap_matches_jax(tmp_path):
    inc, s0_co, s0_cr, _, anc = synthetic_scene(ny=10, nx=12)
    d = tmp_path / "scene"
    d.mkdir()
    for key, arr in (("inc", inc), ("sigma0", s0_co), ("sigma0_dual", s0_cr),
                     ("ancillary_wind", anc)):
        np.save(d / f"{key}.npy", arr)
    assert isinstance(pcli._load_scene(str(d))["inc"], np.memmap)
    ref, got = run_both(tmp_path, d, DUAL)
    assert got["wind_dual"].shape == inc.shape
    assert np.isfinite(np.abs(got["wind_dual"])).any()
    for key in ("wind_co", "wind_dual"):
        assert_parity(got[key], ref[key])


def test_cli_invert_refusals(tmp_path, monkeypatch):
    inc, s0_co, _, _, anc = synthetic_scene(ny=8, nx=8)
    scene = tmp_path / "scene.npz"
    np.savez(scene, inc=inc, sigma0=s0_co, ancillary_wind=anc)
    out = str(tmp_path / "w.npz")
    # 3+ models without a dual channel: never a silent single-pol run
    with pytest.raises(SystemExit, match="no 'sigma0_dual'"):
        pcli.main(["invert", str(scene), out, "--model", "gmf_cmod5n,gmf_s1_v2,gmf_rs2_v2",
                   "--mode", "exact", "--device", "cpu"])
    # the JAX package's mode names point at the port's
    for jax_mode, port_mode in (("pallas", "fused"), ("pallas_exact", "fused_exact")):
        with pytest.raises(SystemExit, match=f"--mode {port_mode}"):
            pcli.main(["invert", str(scene), out, "--model", "gmf_cmod5n", "--mode", jax_mode,
                       "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown inversion mode 'fast'"):
        pcli.main(["invert", str(scene), out, "--model", "gmf_cmod5n", "--mode", "fast",
                   "--device", "cpu"])
    # the default device is the card: without one, an error naming it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        pcli.main(["invert", str(scene), out, "--model", "gmf_cmod5n"])
    assert not os.path.exists(out)


def _listed(out):
    """{name: pol} of a ``list`` table (header line first)."""
    rows = [line.split() for line in out.strip().splitlines()[1:]]
    return {r[0]: r[-1] for r in rows}


def test_cli_list_matches_jax(capsys):
    jcli.main(["list"])
    jax_rows = _listed(capsys.readouterr().out)
    pcli.main(["list"])
    port_rows = _listed(capsys.readouterr().out)
    builtin = {name for _, name, *_ in P.GmfModel._deferred}
    assert builtin <= set(port_rows) and builtin <= set(jax_rows)
    for name in set(port_rows) & set(jax_rows):
        assert port_rows[name] == jax_rows[name], name
    assert port_rows["gmf_cmod5n"] == "VV"
    pcli.main(["list", "--pol", "VH"])
    vh = _listed(capsys.readouterr().out)
    assert vh and set(vh.values()) == {"VH"} and "gmf_s1_v2" in vh


@pytest.fixture
def sarwing_registries(monkeypatch):
    """Both registries cut down to the two sarwing pickle LUT models."""
    names = ("sarwing_lut__fix_co_2_1", "sarwing_lut__fix_cr_2_1")
    for M in (J, P):
        M.register_pickle_luts(os.path.join(DATA, "sarwing_luts"))
        monkeypatch.setattr(M.Model, "_available_models",
                            {n: M.Model._available_models[n] for n in names})
    return names


def _assert_same_attrs(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("cmd,ext,readers", [
    ("models-to-packed", "xstl", (jio.read_packed_lut, pio.read_packed_lut)),
    ("models-to-nc", "nc", (jio.read_lut, pio.read_lut)),
])
def test_cli_models_to_files_cross_read(tmp_path, capsys, sarwing_registries, cmd, ext,
                                        readers):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcli.main([cmd, str(jdir)])
    pcli.main([cmd, str(pdir)])
    out = capsys.readouterr().out
    for name in sarwing_registries:
        fname = f"nc_lut_{name}.{ext}"
        assert f"Wrote {pdir / fname}" in out
        jfile, pfile = str(jdir / fname), str(pdir / fname)
        for read in readers:  # each package reads both files alike
            a, b = read(jfile), read(pfile)
            assert tuple(a.dims) == tuple(b.dims)
            np.testing.assert_array_equal(np.asarray(b.values), np.asarray(a.values))
            for d in a.dims:
                np.testing.assert_array_equal(np.asarray(b.coords[d]), np.asarray(a.coords[d]))
            _assert_same_attrs(a.attrs, b.attrs)
        if ext == "xstl":
            assert open(jfile, "rb").read() == open(pfile, "rb").read()
