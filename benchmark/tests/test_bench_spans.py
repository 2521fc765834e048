"""The readers of the program's spans on hand-built trace events: self time
leaves out the ``xs.*`` spans nested inside, ``compute_idle_pct`` counts only
the device's idle inside ``xs.compute``, and a trace without ``xs.*`` spans
reads None."""

import importlib.util
from types import SimpleNamespace

import pytest

from benchmark import spans, tracing

LAYERS = {"kernels": [], "other": "rest", "copies": "copies"}


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def reader(root, name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, root / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def traced(events, pixels=2_000_000):
    trace = tracing.Trace([ev(tracing.WINDOW, "user_annotation", 0, 1000)] + events, LAYERS)
    return SimpleNamespace(trace=trace, pixels=pixels)


def annotations(*spans_):
    return [ev(name, "user_annotation", ts, dur) for name, ts, dur in spans_]


# one call of one piece from host: validate, tables, prep (with a pin inside),
# compute (with its stages), drain (with the copy's wait inside), merge
CALL = annotations(
    ("benchmark.scene", 10, 900), ("xs.call", 20, 880),
    ("xs.validate", 25, 30), ("xs.tables", 60, 10),
    ("xs.prep", 80, 100), ("xs.pin", 100, 40),
    ("xs.compute", 200, 300), ("xs.bucket", 210, 50), ("xs.coarse", 260, 100),
    ("xs.drain", 520, 200), ("xs.wait.copy", 530, 150),
    ("xs.merge", 750, 100), ("aten::copy_", 760, 20))


def test_self_time_leaves_out_nested_spans():
    own = spans.self_us(traced(CALL).trace)
    assert own["xs.prep"] == 60  # 100 less the pin's 40
    assert own["xs.compute"] == 150  # 300 less the stages' 150
    assert own["xs.drain"] == 50 and own["xs.wait.copy"] == 150
    assert own["xs.merge"] == 100  # a cpu_op inside is not a span of the program
    # the call less the union of everything inside: 30 + 10 + 100 + 300 + 200 + 100
    assert own["xs.call"] == 880 - 740
    assert "benchmark.scene" not in own


def test_self_time_takes_the_union_of_overlapping_children():
    own = spans.self_us(traced(annotations(
        ("xs.call", 0, 100), ("xs.prep", 10, 40), ("xs.wait.prep", 30, 40))).trace)
    assert own["xs.call"] == 100 - 60  # the children cover 10-70


def test_host_prep_and_device_wait_per_mpx(root):
    run = traced(CALL)  # 2 Mpx
    # validate 30 + tables 10 + prep's self 60 + merge 100 = 200 us
    assert reader(root, "host_prep_ms_per_mpx")(run) == pytest.approx(0.2 / 2)
    assert reader(root, "device_wait_ms_per_mpx")(run) == pytest.approx(0.15 / 2)


def test_compute_idle_counts_only_the_idle_inside_compute(root):
    events = annotations(("xs.call", 100, 700), ("xs.compute", 200, 300),
                         ("xs.compute", 600, 100)) + [
        ev("k1", "kernel", 150, 100),  # busy 200-250 inside the first piece
        ev("k2", "kernel", 300, 50),  # busy 300-350
        ev("m", "gpu_memcpy", 450, 300),  # busy 450-500, and the whole second piece
    ]
    run = traced(events)
    # the first piece's 300 us hold 150 busy, the second piece none idle: 150 of 1000
    assert reader(root, "compute_idle_pct")(run) == pytest.approx(15.0)
    idle_total = reader(root, "device_idle_pct.resident")(run)
    assert idle_total == pytest.approx(100.0 * (1000 - 100 - 50 - 300) / 1000)
    assert reader(root, "compute_idle_pct")(run) <= idle_total


def test_spans_outside_the_window_are_clipped(root):
    run = traced(annotations(("xs.compute", -100, 200)))
    assert reader(root, "compute_idle_pct")(run) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["host_prep_ms_per_mpx", "device_wait_ms_per_mpx",
                                  "compute_idle_pct"])
def test_a_trace_without_the_programs_spans_reads_none(root, name):
    events = annotations(("benchmark.scene", 10, 900), ("aten::nonzero", 20, 5))
    events.append(ev("k1", "kernel", 50, 100))
    assert reader(root, name)(traced(events)) is None
    assert reader(root, name)(SimpleNamespace(trace=None, pixels=1)) is None
