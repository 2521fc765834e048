"""The frozen GMFs and the reference's tables agree with the port's CPU
path; the judge passes the port and the reference in float64, and fails
the reference in bfloat16 (the control) at a size a test run can hold."""

import numpy as np
import pytest
import torch

from benchmark import system
from benchmark.calibrate import readings
from benchmark.harness import Cell
from benchmark.reference import gmfs
from benchmark.reference.judge import Judge, sample_inputs_f64
from benchmark.reference.luts import Tables

CPU = torch.device("cpu")
CELLS = ("s1_iw_resident", "s1_iw_host", "lut_scansar_resident")


def test_frozen_gmfs_equal_the_ports():
    from xsarsea_tpu_torch.models import get_model

    rng = np.random.default_rng(0)
    inc = torch.as_tensor(rng.uniform(16, 66, 4096))
    wspd = torch.as_tensor(rng.uniform(0.2, 50, 4096))
    phi = torch.as_tensor(rng.uniform(0, 360, 4096))
    assert torch.equal(gmfs.gmf_cmod5n(inc, wspd, phi),
                       get_model("gmf_cmod5n")(inc, wspd, phi, broadcast=True))
    assert torch.equal(gmfs.gmf_s1_v2(inc, wspd + 3),
                       get_model("gmf_s1_v2")(inc, wspd + 3, broadcast=True))
    from xsarsea_tpu_torch.windspeed.dsig import get_dsig

    s0 = gmfs.gmf_s1_v2(inc, wspd + 3)
    nesz = torch.full_like(s0, 10 ** -2.4)
    assert torch.equal(gmfs.dsig_s1_v2(inc, s0, nesz), get_dsig("gmf_s1_v2", inc, s0, nesz,
                                                                device="cpu"))


@pytest.mark.parametrize("config", ["s1_dualpol_cmod5n_s1v2", "lut_cmod7_sarwing"])
def test_reference_tables_equal_the_ports(root, config):
    cell = Cell(root, "s1_iw_host" if config.startswith("s1") else "lut_scansar_resident")
    ref = Tables(cell.config, root)
    port = system.build(cell.config, root, CPU).tables
    for f in ("co_lut", "co_inc", "co_wspd", "co_phi", "co_u", "co_v", "cr_lut", "cr_inc",
              "cr_wspd"):
        assert np.array_equal(getattr(ref, f), getattr(port, f)), f
    assert ref.phi_180 == port.phi_180
    assert list(ref.co_lut.shape) == cell.config["shapes"]["copol_lut"]
    assert list(ref.cr_lut.shape) == cell.config["shapes"]["crosspol_lut"]


def tiny(root, name):
    cell = Cell(root, name)
    cell.traffic = dict(cell.traffic, lines=16, samples=40, pool=2)
    cell.checks = dict(cell.checks, sample_per_scene=320)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_port_passes_and_the_bfloat16_control_fails(root, name):
    cell = tiny(root, name)
    r = readings(cell, [2 ** 31 + 3], [2 ** 31 + 4, 2 ** 31 + 5, 17], CPU, root=root)
    limits = {k: v["limit"] for k, v in cell.checks["checks"].items()}
    prog = r["program"][2 ** 31 + 3]
    assert all(prog[k] <= limits[k] for k in limits), prog
    for values in r["control"].values():
        assert any(values[k] > limits[k] for k in limits), values


@pytest.mark.parametrize("name", CELLS)
def test_reference_in_float64_in_the_programs_place_passes(root, name):
    import importlib

    from benchmark.harness import build_pool

    cell = tiny(root, name)
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    judge = Judge(Tables(cell.config, root), cell.config["dsig_co"], CPU)
    _, _, _, received = build_pool(cell, entry, 99, CPU)
    for x in received:
        x = sample_inputs_f64(x)
        co, du = judge.invert(x, torch.float64, entry.MERGED)
        v = judge.judge(x, co, du, entry.MERGED)
        # float64 rounding of two evaluation orders of one cost
        assert float(v["co_gap"].max()) < 1e-6
        assert float(v["dual_gap"].max()) < 1e-6
        assert not v["post_error"].any()
        # land pixels are in the sample and come back NaN
        assert torch.isnan(co).any() == torch.isnan(x["s0_co_db"]).any()
