"""The cell of xsarsea's L1 chain in one call (``s1_iw_prep_host``): its
traffic's VH NESZ field, the judge's reference chain (``reference/prep.py``)
against the repository tests' copy, the reader of ``scene_prep_ms_per_mpx``
on hand-built trace events, and tiny runs on the CPU: a sound one is correct
and reports the cell's metrics, a control that weights with the raw NESZ in
place of the flattened one is not."""

import importlib.util
import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import traffic as traffic_gen
from benchmark.entries import chain
from benchmark.harness import Cell, run_cell
from benchmark.reference import prep
from benchmark.tests.test_bench_spans import annotations, reader, traced

CPU = torch.device("cpu")
SEED = 2 ** 31 + 27027
CELL = "s1_iw_prep_host"


def tiny(root):
    cell = Cell(root, CELL)
    cell.traffic = dict(cell.traffic, lines=16, samples=60, pool=2)
    cell.checks = dict(cell.checks, sample_per_scene=480)
    return cell


def scenes(root, seed, lines=64, samples=300):
    cell = Cell(root, CELL)
    traffic = dict(cell.traffic, lines=lines, samples=samples)
    gen = traffic_gen.generator(seed, CPU)
    return [traffic_gen.make_scene(traffic, cell.config, gen, plan, CPU)
            for plan in traffic_gen.scene_plan(dict(traffic, pool=2), gen)], cell


def test_the_cell_names_the_entrys_chain(root):
    cell = Cell(root, CELL)
    assert cell.traffic["entry"] == "chain" and chain.TRAFFIC.stem == cell.workload["traffic"]
    assert cell.config["dsig_cr"] == {"scheme": chain.SCHEME, "from": "nesz_cr"}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    p95 = next(m for m in spec["end_to_end"] if m["name"] == "scene_p95_s")
    assert CELL not in p95["workloads"]


def test_the_nesz_field(root):
    (a, b), cell = scenes(root, SEED)
    traffic = cell.traffic
    f = traffic["nesz_cr_field"]
    nesz = chain.nesz_field(a, traffic, chain.field_generator(a))
    again = chain.nesz_field(a, traffic, chain.field_generator(a))
    other = chain.nesz_field(b, traffic, chain.field_generator(b))
    assert nesz.shape == (64, 300) and nesz.dtype == torch.float64
    assert torch.equal(nesz.isnan(), again.isnan()) and torch.equal(nesz.nan_to_num(),
                                                                    again.nan_to_num())
    assert not torch.equal(nesz.nan_to_num(), other.nan_to_num())
    assert int(nesz.isnan().sum()) == f["nan_samples"]
    # the ramp, the subswath steps and the noise, in dB
    inc = a["inc"].view(64, 300)
    resid = 10.0 * torch.log10(nesz) - traffic["nesz_cr_db"] \
        - f["slope_db_per_deg"] * (inc - f["inc0_deg"])
    for k, off in enumerate(f["subswath_offsets_db"]):
        part = resid[:, k * 100:(k + 1) * 100]
        part = part[~part.isnan()]
        assert abs(float(part.mean()) - off) < 0.02
        assert abs(float(part.std()) - f["noise_db"]) < 0.01


def load_tests_reference(root):
    spec = importlib.util.spec_from_file_location("prep_reference_of_the_tests",
                                                  root / "tests" / "_prep_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("inc_form", ["full", "vector"])
def test_the_judges_reference_is_the_tests_copy(root, inc_form):
    other = load_tests_reference(root)
    rng = np.random.default_rng(5)
    inc = np.linspace(30, 46, 70)[None, :] + rng.normal(0, 0.01, (20, 70))
    if inc_form == "vector":
        inc = inc[0]
    nesz = 10 ** ((-25 + rng.normal(0, 0.3, (20, 70))) / 10)
    nesz[3] = np.nan
    nesz[9] = 0.0
    nesz[rng.integers(0, 20, 10), rng.integers(0, 70, 10)] = np.nan
    s0 = rng.uniform(1e-4, 1e-2, (20, 70))
    for name in prep.DSIG_NAMES:
        got = prep.dsig_from_nesz(name, inc, s0, nesz)
        want = other.dsig_from_nesz(name, inc, s0, nesz)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    flat = prep.nesz_flattening(nesz, inc)
    assert flat[9].isnan().all() and flat[3].isfinite().all()


def test_scene_prep_per_mpx_reads_the_chains_spans(root):
    read = reader(root, "scene_prep_ms_per_mpx")
    run = traced(annotations(("xs.call", 0, 900), ("xs.nesz", 10, 100), ("xs.read", 20, 30),
                             ("xs.prep", 200, 300), ("xs.dsig", 250, 40)))  # 2 Mpx
    # nesz's self 70 + dsig's 40 = 110 us over 2 Mpx
    assert read(run) == pytest.approx(0.110 / 2)
    assert read(traced(annotations(("xs.call", 0, 900), ("xs.prep", 200, 300)))) is None
    assert read(SimpleNamespace(trace=None, pixels=1)) is None


def test_a_sound_chain_run_is_correct_and_reports_the_cells_metrics(root):
    cell = tiny(root)
    result, lines, info = run_cell(root, CELL, SEED, 0.05, False, CPU, time.perf_counter(),
                                   cell=cell)
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["metrics"]) == {"host_mpx_s", "setup_s"}


def test_weighting_with_the_raw_nesz_is_not_correct(root, monkeypatch):
    """The control: ``get_dsig`` of the raw NESZ, unflattened, handed to the
    program as an array, judged against the reference's chain."""
    from xsarsea_tpu_torch.windspeed import get_dsig

    def invert(program, placed):
        dsig = get_dsig(chain.SCHEME, placed["inc"], placed["s0_cr"], placed["nesz_cr"],
                        device=program.device)
        return program.invert_from_model(
            placed["inc"], placed["s0_co"], placed["s0_cr"], ancillary_wind=placed["anc"],
            dsig_co=program.dsig_co, dsig_cr=dsig, model=program.models, dtype=program.dtype,
            mode=program.mode, device=program.device)

    monkeypatch.setattr(chain, "invert", invert)
    result, lines, _ = run_cell(root, CELL, SEED, 0.05, False, CPU, time.perf_counter(),
                                cell=tiny(root))
    assert not result["correct"], lines
    assert math.isfinite(result["checks"]["dual_gap"]["value"])
