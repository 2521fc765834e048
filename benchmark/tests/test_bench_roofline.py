"""The roofline counts equal hand-worked values; the trace's reduction."""

import pytest

from benchmark import roofline as R
from benchmark import tracing


def test_coarse_grid_of_the_fused_mode():
    # 499 speeds at 0.1 m/s, stride 8: rows 0, 8, ..., 496 and 498; 181
    # directions at 1 deg, stride 4: columns 0, 4, ..., 180
    assert R.coarse_grid(499, 181, 0.1, 1.0) == (64, 46)
    # a small shape by hand: rows {0, 8, 16, 19}, columns {0, 4, 8}
    assert R.coarse_grid(20, 9, 0.1, 1.0) == (4, 3)
    assert R.SLAB_ROWS == 48


def test_work_of_a_small_shape_by_hand():
    w = R.Work((3, 20, 9), 0.1, 1.0, 3, 5, fused_tail=True)
    ops, n_bytes = w.coarse(100)
    assert ops == 100 * 4 * 3 * 10
    assert n_bytes == (3 * 12 + 2 * 12 + 4) * 4 + 100 * 5 * 4
    ops, n_bytes = w.refine(100, 90)
    assert ops == 100 * 48 * 9 * 10 + 90 * 5 * 8
    assert n_bytes == (3 * 20 * 9 + 2 * 20 * 9 + 3 * 5) * 4 + 100 * 11 * 4
    w2 = R.Work((3, 20, 9), 0.1, 1.0, 2, 5, fused_tail=False)
    assert w2.refine(100, 90)[1] == (3 * 20 * 9 + 2 * 20 * 9 + 2 * 5) * 4 + (100 + 90) * 5 * 4
    assert R.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert R.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_the_benchmark_scenes_bound_matches_the_kernel_table():
    # PERF.md's kernel table: K1 1.843 ms and K2 5.825 ms for a 2^22-px piece
    w = R.Work((501, 499, 181), 0.1, 1.0, 501, 771, fused_tail=True)
    n = 1 << 22
    assert R.bound_s(*w.coarse(n)) * 1e3 == pytest.approx(1.843, rel=2e-3)
    assert R.bound_s(*w.refine(n, n)) * 1e3 == pytest.approx(5.825, rel=2e-3)


LAYERS = {"kernels": [["\\bgroup_argmin_kernel\\b", "K1"], ["\\bslab_refine_kernel\\b", "K3"]],
          "other": "rest", "copies": "copies"}


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_trace_reduction():
    events = [
        ev(tracing.WINDOW, "user_annotation", 100, 100),
        ev("void group_argmin_kernel(float const*)", "kernel", 110, 10),
        ev("void slab_refine_kernel<8>(float const*)", "kernel", 115, 20),
        ev("void at::native::sort_kernel()", "kernel", 150, 5),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 160, 10, bytes=1000),
        ev("Memset (Device)", "gpu_memset", 175, 5),
        ev("aten::nonzero", "cpu_op", 135, 14),
        ev("cudaStreamSynchronize", "cuda_runtime", 180, 19),
        ev("outside", "kernel", 300, 10),
    ]
    t = tracing.Trace(events, LAYERS)
    assert t.window_us == 100
    assert t.busy_us == 25 + 5 + 10 + 5  # 110-135, 150-155, 160-170, 175-180
    assert t.layer_us("K1") == 10 and t.layer_us("K3") == 20 and t.layer_us("rest") == 5
    assert t.memcpy() == (1000.0, 10.0)
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("void slab_refine_kernel")
    idle = dict(b["idle_gaps"])
    assert idle["aten::nonzero"] == pytest.approx(15e-6)  # the gap 135-150
    assert idle["cudaStreamSynchronize"] == pytest.approx(20e-6)  # 180-200
    # 100-110, 155-160 and 170-175: inside the window's annotation only
    assert idle[tracing.WINDOW] == pytest.approx(20e-6)
    assert tracing.union_us([(0, 2), (1, 3), (5, 6)]) == 4
