"""One run of one cell: set-up, the measured window, the correctness check,
the metrics, the result line.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:
the configuration's file (``configs``), the traffic file
``benchmark/traffic/<traffic>.json`` and its entry
``benchmark/entries/<entry>.py``, the cell's checks
``benchmark/cells/<cell>.json``, and each metric's reader
``benchmark/metrics/<metric>.py``. Nothing here names a cell.

The window is a closed loop of one caller: scene ``k`` of the pool
(``k mod pool``) is handed to the program when scene ``k - 1`` has returned
its winds, until ``--seconds`` have passed; the last scene is finished, and
the window ends when it returns. Each call's winds on a sample of pixels
(drawn from the seed per scene) are kept and judged against the plain
reference once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import system, tracing
from benchmark import traffic as traffic_gen
from benchmark.reference.judge import MISS_GAP, Judge, sample_inputs_f64
from benchmark.reference.luts import Tables
from benchmark.roofline import Work, bound_s

FORBIDDEN = ("jax", "jaxlib", "flax", "xsarsea_tpu")
WARMUP_CALLS = 2
COARSE = "coarse group argmin (K1)"
REFINE = "slab refine and crosspol tail (K2; or K3 + K4)"


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's pieces, read from ``BENCHMARK.json`` and the files it names."""

    def __init__(self, root, name):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        cfg = next(c for c in self.spec["configs"] if c["name"] == self.workload["config"])
        self.config = load_json(self.root / cfg["file"])
        bench = self.root / "benchmark"
        self.traffic = load_json(bench / "traffic" / f"{self.workload['traffic']}.json")
        self.checks = load_json(bench / "cells" / f"{name}.json")

    def metrics(self, kind):
        """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric):
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _live(scene):
    ok = ~torch.isnan(scene["inc"]) & ~torch.isnan(scene["anc_re"]) \
        & ~torch.isnan(scene["anc_im"])
    co = int((ok & ~torch.isnan(scene["s0_co"])).sum())
    cr = int((ok & ~torch.isnan(scene["s0_cr"]) & ~torch.isnan(scene["dsig_cr"])).sum())
    return co, cr


def _bits(z):
    return torch.view_as_real(z).contiguous().view(torch.int32)


def verdict_values(verdict):
    """The numbers a call's verdict is held to: the share of its sampled
    pixels whose winds the reference does not accept (a copol cost more than
    ``MISS_GAP`` above the grid's least, a miss of the exact argmin's cell
    and not a tie to rounding, or any post-processing error), and the widest
    crosspol gap; and, shown but not compared, the count of post-processing
    errors and the widest copol gap."""
    miss = (verdict["co_gap"] > MISS_GAP) | verdict["post_error"]
    return {"miss_share": int(miss.sum()) / max(1, miss.numel()),
            "dual_gap": float(verdict["dual_gap"].max()),
            "post_errors": int(verdict["post_error"].sum()),
            "co_gap": float(verdict["co_gap"].max())}


def judge_calls(judge, received, outs, merged, checks):
    """Judge every call's sampled winds. Calls of one scene whose winds are
    the same bit for bit are judged once. Returns the values (the worst over
    all calls), the number of calls that failed a check, a few failing
    pixels, and the number of distinct winds of each scene."""
    worst = {}
    failed = 0
    examples = []
    by_scene = {}
    for j, (co, du) in outs:
        variants = by_scene.setdefault(j, [])
        for v in variants:
            if torch.equal(v["co"], _bits(co)) and torch.equal(v["du"], _bits(du)):
                v["calls"] += 1
                break
        else:
            variants.append({"co": _bits(co), "du": _bits(du), "winds": (co, du), "calls": 1})
    for j, variants in by_scene.items():
        x = {k: v.to(judge.device) for k, v in received[j].items()}
        for v in variants:
            co, du = (w.to(judge.device) for w in v["winds"])
            verdict = judge.judge(x, co, du, merged)
            values = verdict_values(verdict)
            if any(not values[k] <= checks[k]["limit"] for k in checks):
                failed += v["calls"]
                bad = verdict["post_error"] | (verdict["co_gap"] > MISS_GAP) \
                    | (verdict["dual_gap"] > checks["dual_gap"]["limit"])
                for i in torch.nonzero(bad).reshape(-1)[:3].tolist():
                    examples.append(f"scene {j} pixel {i}: " + ", ".join(
                        f"{k} {float(t[i])!r}" for k, t in x.items()) + f", co {complex(co[i])!r}, "
                        f"dual {complex(du[i])!r}, " + ", ".join(
                            f"{k} {float(t[i])!r}" for k, t in verdict.items()))
            for k, val in values.items():
                worst[k] = max(worst.get(k, val), val)
    return worst, failed, examples[:9], [len(by_scene[j]) for j in sorted(by_scene)]


def build_pool(cell, entry, seed, device):
    """The cell's pool of scenes from ``seed``, placed as the entry hands them
    to the program, with each scene's live pixel counts (copol, crosspol),
    its sample of pixels (drawn from the seed) and their inputs as the
    program receives them (on the host)."""
    traffic = cell.traffic
    gen = traffic_gen.generator(seed, device)
    pick = traffic_gen.generator(seed * 2 + 1, device)
    placed, live, idx, received = [], [], [], []
    n = int(traffic["lines"]) * int(traffic["samples"])
    m = min(int(cell.checks["sample_per_scene"]), n)
    for j, plan in enumerate(traffic_gen.scene_plan(traffic, gen)):
        scene = traffic_gen.make_scene(traffic, cell.config, gen, plan, device)
        live.append(_live(scene))
        idx.append(torch.unique(torch.randint(0, n, (m,), generator=pick, device=device)))
        placed.append(entry.place(scene))
        del scene
        received.append({k: v.cpu() for k, v in entry.received(placed[j], idx[j]).items()})
    return placed, live, idx, received


def run_cell(root, cell_name, seed, seconds, trace, device, t_start, cell=None):
    """One run of a cell on ``device``. Returns the result line (a dict), the
    lines for standard error (the checks last) and the run's details (the
    metrics' ``run``, the forbidden modules loaded, the memory peak).
    ``cell`` may be given, as the tests do."""
    cell = cell or Cell(root, cell_name)
    traffic, config = cell.traffic, cell.config
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    program = system.build(config, root, device)

    placed, live, idx, received = build_pool(cell, entry, seed, device)
    for j in range(min(WARMUP_CALLS, len(placed))):
        entry.invert(program, placed[j])
    setup_s = time.perf_counter() - t_start

    n = int(traffic["lines"]) * int(traffic["samples"])
    times, outs, calls = [], [], []

    def window():
        t_w0 = time.perf_counter()
        k = 0
        while True:
            j = k % len(placed)
            t0 = time.perf_counter()
            with torch.profiler.record_function("benchmark.scene") if trace else nullcontext():
                winds = entry.invert(program, placed[j])
            t1 = time.perf_counter()
            times.append(t1 - t0)
            calls.append(j)
            outs.append((j, entry.take(winds, idx[j])))
            del winds
            k += 1
            if t1 - t_w0 >= seconds:
                return t1 - t_w0

    events = None
    if trace:
        box = {}

        def traced_window():
            with torch.profiler.record_function(tracing.WINDOW):
                box["s"] = window()

        events = tracing.traced(traced_window)
        window_s = box["s"]
    else:
        window_s = window()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del placed, program
    outs = [(j, tuple(w.cpu() for w in winds)) for j, winds in outs]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference, on its own tables
    tables = Tables(config, root)
    judge = Judge(tables, config["dsig_co"], device)
    received = [sample_inputs_f64(x) for x in received]
    checks = cell.checks["checks"]
    values, failed, examples, variants = judge_calls(judge, received, outs, entry.MERGED, checks)
    correct = failed == 0

    work = Work(tables.co_lut.shape,
                float(torch.median(torch.diff(torch.as_tensor(tables.co_wspd, dtype=torch.float64)))),
                float(torch.median(torch.diff(torch.as_tensor(tables.co_phi, dtype=torch.float64)))),
                tables.cr_lut.shape[0], tables.cr_lut.shape[1],
                tables.co_inc.shape == tables.cr_inc.shape
                and bool((tables.co_inc == tables.cr_inc).all()))
    bounds = {COARSE: sum(bound_s(*work.coarse(live[j][0])) for j in calls),
              REFINE: sum(bound_s(*work.refine(*live[j])) for j in calls)}
    run = SimpleNamespace(setup_s=setup_s, window_s=window_s, scene_s=times, calls=len(calls),
                          pixels=n * len(calls), bounds=bounds,
                          trace=None if events is None else tracing.Trace(
                              events, load_json(Path(root) / "benchmark" / "layers.json")))

    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": {}}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": values[k], "limit": checks[k]["limit"]} for k in checks}
    lines = [f"distinct winds per scene over its calls: {variants}; shown, not compared: "
             f"post-processing errors {values['post_errors']}, widest copol gap "
             f"{values['co_gap']!r}"]
    lines += [f"failing: {e}" for e in examples]
    lines += [f"check {k}: {values[k]!r} (limit {checks[k]['limit']!r})" for k in checks]
    return result, lines, SimpleNamespace(run=run, loaded=loaded, memory_peak=memory_peak)


def _thirds(scene_s):
    """Calls that ended in each third of the window (host time between calls
    aside): a drift inside the window shows here."""
    total, done, counts = sum(scene_s), 0.0, [0, 0, 0]
    for t in scene_s:
        done += t
        counts[min(2, int(3 * done / total))] += 1
    return counts


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv, root, t_start):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = Cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, lines, info = run_cell(root, args.workload, args.seed, args.seconds,
                                   bool(args.trace), device, t_start, cell=cell)
    if info.loaded:
        print(f"modules loaded that the benchmark may not load: {', '.join(info.loaded)}",
              file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": info.memory_peak}
    if info.run.trace is not None:
        device_info["busy_s"] = info.run.trace.busy_us / 1e6
        device_info["window_s"] = info.run.trace.window_us / 1e6
    result["device"] = device_info
    result["checks"] = result.pop("checks")  # the checks come last
    print(f"card and power limit: {_power_limit()}", file=sys.stderr)
    q = statistics.quantiles(info.run.scene_s, n=4) if len(info.run.scene_s) > 1 else [0] * 3
    print(f"calls {result['attempted']}, window {info.run.window_s!r} s, set-up "
          f"{info.run.setup_s!r} s, scene s quartiles {q[0]:.6f} {q[1]:.6f} {q[2]:.6f}, "
          f"calls a third of the window {_thirds(info.run.scene_s)}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
