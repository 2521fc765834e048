#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's fused dual-pol inversion on one GPU.

Run from the repository root: ``python3 chip_profile.py [--out DIR]``. It
needs a CUDA device and ``nvcc``, and imports nothing of JAX. On the
2**23-pixel seed-0 scene of ``chip_smoke.py`` it measures:

1. the card's name and power limit (``nvidia-smi``);
2. one fused ``invert_pixels`` call on device-resident float32 inputs under
   ``torch.profiler``: device time per kernel name, and the device's busy
   share of the call, i.e. the union of the device activity intervals over
   the call's host wall time, both taken in that same profiled call;
3. the rate over 9 timed calls without the profiler: median and quartiles;
4. fused against exact on the first 2**20 pixels of the scene;
5. fused against exact off the GMF manifold: uniform-random sigma0 and
   ancillary wind, seeds 7 and 8, 2**20 pixels each. Differing pixels are
   split into one-LUT-step flips (speed within one wspd step and direction
   within one phi step of exact) and the rest, with the exact-form cost
   of the fused winner above the plane's minimum.

With ``--out DIR`` it writes the profiler's table to
``DIR/profile_table.txt`` and the summary to ``DIR/chip_profile.json``.
The last line of its output is the summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from chip_smoke import cost_gaps, log, make_scene

MODELS = ("gmf_cmod5n", "gmf_s1_v2")


def to_device(torch, inc, s0_co_db, s0_cr_db, dsig_cr, anc):
    f32 = dict(dtype=torch.float32, device="cuda")
    return (torch.as_tensor(inc, **f32), torch.as_tensor(s0_co_db, **f32),
            torch.as_tensor(s0_cr_db, **f32), torch.as_tensor(dsig_cr, **f32),
            torch.as_tensor(anc.astype(np.complex64), device="cuda"))


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_call(torch, once, out_dir):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy_us = union_us([(e.time_range.start, e.time_range.end) for e in dev])
    if out_dir is not None:
        (out_dir / "profile_table.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_sum_ms": sum(per_name.values()) / 1e3,
            "busy_share": busy_us / wall_us if dev else None,
            "kernels_ms": {name[:120]: us / 1e3 for name, us in top[:12]}}


def compare(torch, tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc):
    """Fused against exact on the card: differing pixels, split by size."""
    args = to_device(torch, inc, s0_co_db, s0_cr_db, dsig_cr, anc)
    fused = invert(tables, args, "fused")[0]
    exact = invert(tables, args, "exact")[0]
    differ = ~((fused == exact) | (np.isnan(fused) & np.isnan(exact)))
    idx = np.nonzero(differ)[0]
    dw = np.abs(np.abs(fused[idx]) - np.abs(exact[idx]))
    dphi = np.abs(np.angle(fused[idx] * np.conj(exact[idx]), deg=True))
    step_w = float(np.median(np.diff(tables.co_wspd)))
    step_p = float(np.median(np.diff(tables.co_phi)))
    near = (dw <= step_w * 1.001) & (dphi <= step_p * 1.001)
    gap, jmin = cost_gaps(torch, tables, inc[idx], s0_co_db[idx], anc[idx], fused[idx])
    rel = gap / np.maximum(jmin, np.finfo(np.float32).tiny)
    far = ~near
    return {"pixels": int(inc.shape[0]), "differing": int(idx.size),
            "one_step_flips": int(near.sum()), "other": int(far.sum()),
            "max_dev_m_s": float(dw.max()) if idx.size else 0.0,
            "other_max_dev_m_s": float(dw[far].max()) if far.any() else 0.0,
            "max_rel_cost_gap": float(rel.max()) if idx.size else 0.0,
            "other_max_rel_cost_gap": float(rel[far].max()) if far.any() else 0.0,
            "min_cost_gap": float(gap.min()) if idx.size else 0.0}


def invert(tables, args, mode):
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    return invert_pixels(tables, *args, mode=mode, device="cuda", chunk_size=1024)


def off_gmf_scene(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(18.0, 47.0, n), rng.uniform(-30.0, 0.0, n),
            rng.uniform(-40.0, -15.0, n), np.full(n, 0.1),
            rng.uniform(0.5, 25.0, n) * np.exp(1j * rng.uniform(0.0, 2 * np.pi, n)))


def run(out_dir, n=1 << 23, n_cmp=1 << 20, reps=9):
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from xsarsea_tpu_torch.models import get_model
    from xsarsea_tpu_torch.ops import inversion_kernels as K
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels, prepare_tables

    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(card)
    K.build_kernels()
    sc = make_scene(torch, get_model, n)
    tables = prepare_tables(*MODELS, dtype=torch.float32)
    dev = to_device(torch, sc["inc"], sc["s0_co_db"], sc["s0_cr_db"], sc["dsig_cr"], sc["anc"])

    def once():
        out = invert_pixels(tables, *dev, mode="fused", device="cuda", device_output=True)
        torch.cuda.synchronize()
        return out

    once()
    prof = profile_call(torch, once, out_dir)
    log(f"profiled call ({n} px): wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_busy_ms']:.3f} ms (share {prof['busy_share']}), per kernel "
        f"{json.dumps(prof['kernels_ms'])}")

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    q1, med, q3 = statistics.quantiles(times, n=4)
    rate = {"mpx_s": n / med / 1e6, "median_s": med, "q1_s": q1, "q3_s": q3, "runs": reps}
    log(f"rate over {reps} calls: {json.dumps(rate)}")

    bench = compare(torch, tables, sc["inc"][:n_cmp], sc["s0_co_db"][:n_cmp],
                    sc["s0_cr_db"][:n_cmp], sc["dsig_cr"][:n_cmp], sc["anc"][:n_cmp])
    log(f"fused vs exact, bench scene first {n_cmp} px: {json.dumps(bench)}")
    off = {}
    for seed in (7, 8):
        off[seed] = compare(torch, tables, *off_gmf_scene(n_cmp, seed))
        log(f"fused vs exact, off-GMF seed {seed}: {json.dumps(off[seed])}")

    summary = {"card": card, "profile": prof, "rate": rate, "bench_parity": bench,
               "off_gmf_parity": off}
    if out_dir is not None:
        (out_dir / "chip_profile.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for the profiler table and the JSON summary")
    sys.exit(run(parser.parse_args().out))
