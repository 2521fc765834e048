"""The readings that a cell's limits are set from, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out readings.json]

For each of ``--seeds``: the cell's pool of scenes, each scene once through
the program's timed entry (no window), judged as a run judges its calls: the
lower readings. For each of ``--control-seeds``: the reference put in the
program's place with its costs in bfloat16, the precision below the float32
the configuration states, judged the same way: the upper readings. The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import importlib  # noqa: E402

import torch  # noqa: E402

from benchmark import system  # noqa: E402
from benchmark.harness import Cell, build_pool, judge_calls  # noqa: E402
from benchmark.reference.judge import Judge, sample_inputs_f64  # noqa: E402
from benchmark.reference.luts import Tables  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def readings(cell, seeds, control_seeds, device, root=ROOT):
    """``{"program": {seed: values}, "control": {seed: values}}``."""
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    program = system.build(cell.config, root, device)
    judge = Judge(Tables(cell.config, root), cell.config["dsig_co"], device)
    checks = cell.checks["checks"]
    out = {"program": {}, "control": {}}
    for seed in seeds:
        placed, _, idx, received = build_pool(cell, entry, seed, device)
        outs = [(j, tuple(w.cpu() for w in entry.take(entry.invert(program, p), idx[j])))
                for j, p in enumerate(placed)]
        del placed
        received = [sample_inputs_f64(x) for x in received]
        out["program"][seed] = judge_calls(judge, received, outs, entry.MERGED, checks)[0]
        print(json.dumps({"seed": seed, "program": out["program"][seed]}), flush=True)
    for seed in control_seeds:
        placed, _, _, received = build_pool(cell, entry, seed, device)
        del placed
        received = [sample_inputs_f64(x) for x in received]
        outs = []
        for j, x in enumerate(received):
            x = {k: v.to(device) for k, v in x.items()}
            outs.append((j, tuple(w.cpu() for w in judge.invert(x, CONTROL_DTYPE,
                                                                  entry.MERGED))))
        out["control"][seed] = judge_calls(judge, received, outs, entry.MERGED, checks)[0]
        print(json.dumps({"seed": seed, "control": out["control"][seed]}), flush=True)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    res = readings(cell, seeds, control, torch.device("cuda", 0))
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
               "seconds": time.perf_counter() - T_START, **res}
    for kind in ("program", "control"):
        for k in ("miss_share", "dual_gap", "post_errors", "co_gap"):
            vals = [v[k] for v in res[kind].values()]
            if vals:
                summary[f"{kind}_{k}_min_max"] = [min(vals), max(vals)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k.endswith("min_max")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
