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
   of the fused winner above the plane's minimum;
6. steps 2-4 again for the unfused tail, on ``chip_smoke.py``'s phase-7
   pair (CMOD7 high-res with the sarwing crosspol LUT on its own
   incidence axis);
7. one profiled call of ``chip_smoke.py``'s phase-9 steps 1-2 (scene
   preparation on DimArrays over host arrays, then ``invert_from_model``
   through the xarray bridge with a per-pixel ``dsig_cr`` array) on its
   2,048 x 4,096 scene: device busy share, device time per kernel name and
   the host operations with the most self time (where the host waits: the
   copies to and from the card, the piece loop);
8. ``chip_smoke.py``'s phase-4 call, dual-pol ``invert_from_model`` on the
   2**23-pixel scene from host float64 arrays to host winds, profiled through
   the overlapped piece loop and through the serial one: wall, device busy
   share, the copies each way with their GB/s (bytes from the streams'
   sizes), host self time; then 5 unprofiled calls of each, in turns;
9. ``chip_smoke.py``'s phase-10 single-scale call, ``streaks_histogram_core``
   on the device-resident 4,096 x 4,096 tile: one profiled call (device
   operations by time, busy share), and its stages one by one from CUDA
   events: the stencil cascade, the window gather, the median sort, the
   weights with the histogram's scatter; beside each the bytes it must move
   (each input read once, each output written once) over 3.35 TB/s as its
   bound, and its share of the stages' sum.

With ``--out DIR`` it writes the profiler's tables to
``DIR/profile_table.txt``, ``DIR/profile_table_unfused.txt``,
``DIR/profile_table_scene_prep.txt``, ``DIR/profile_table_host_inout.txt``,
``DIR/profile_table_host_inout_serial.txt`` and
``DIR/profile_table_streaks.txt`` and the summary to
``DIR/chip_profile.json``.
The last line of its output is the summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from chip_smoke import (PEAK_BYTES, cost_gaps, host_seconds, invert_labelled, log, prep_scene,
                        prepare_scene, serial_piece_loop, synthetic_tile, unfused_pair)

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


def profile_call(torch, once, out_dir, table_name):
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
        (out_dir / table_name).write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    copies = {way: sum(us for name, us in per_name.items() if name.startswith(f"Memcpy {way}"))
              / 1e3 for way in ("HtoD", "DtoH")}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_sum_ms": sum(per_name.values()) / 1e3,
            "busy_share": busy_us / wall_us if dev else None, "copies_ms": copies,
            "kernels_ms": {name[:120]: us / 1e3 for name, us in top[:12]},
            "host_self_ms": {a.key[:80]: a.self_cpu_time_total / 1e3 for a in host[:10]}}


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


def profile_and_rate(torch, tables, dev, out_dir, table_name, reps, what):
    """One profiled device-resident fused call after a warm-up, then the
    rate over ``reps`` calls without the profiler."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    n = dev[0].shape[0]

    def once():
        out = invert_pixels(tables, *dev, mode="fused", device="cuda", device_output=True)
        torch.cuda.synchronize()
        return out

    once()
    prof = profile_call(torch, once, out_dir, table_name)
    log(f"{what}: profiled call ({n} px): wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_busy_ms']:.3f} ms (share {prof['busy_share']}), per kernel "
        f"{json.dumps(prof['kernels_ms'])}")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    q1, med, q3 = statistics.quantiles(times, n=4)
    rate = {"mpx_s": n / med / 1e6, "median_s": med, "q1_s": q1, "q3_s": q3, "runs": reps}
    log(f"{what}: rate over {reps} calls: {json.dumps(rate)}")
    return prof, rate


def host_in_out(torch, sc, out_dir, reps=5):
    """The phase-4 call through the overlapped piece loop and the serial one:
    a profile of each, then ``reps`` unprofiled calls of each, in turns."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_from_model

    n = sc["inc"].shape[0]
    bytes_in, bytes_out = 5 * n * 4, 2 * n * 8  # five float32 streams in, two complex64 out

    def once():
        winds = invert_from_model(sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"],
                                  dsig_co=0.1, dsig_cr=0.1, model=MODELS, device="cuda")
        torch.cuda.synchronize()
        return winds

    def serial_once():
        with serial_piece_loop():
            return once()

    once()
    out = {}
    for name, fn, table in (("overlapped", once, "profile_table_host_inout.txt"),
                            ("serial", serial_once, "profile_table_host_inout_serial.txt")):
        prof = profile_call(torch, fn, out_dir, table)
        prof["copy_gb_s"] = {way: nbytes / prof["copies_ms"][way] / 1e6
                             if prof["copies_ms"][way] else None
                             for way, nbytes in (("HtoD", bytes_in), ("DtoH", bytes_out))}
        out[name] = prof
    times = {"overlapped": [], "serial": []}
    for _ in range(reps):
        times["overlapped"].append(host_seconds(torch, once)[1])
        times["serial"].append(host_seconds(torch, serial_once)[1])
    for name, ts in times.items():
        out[name]["seconds"] = ts
        out[name]["median_s"] = statistics.median(ts)
        log(f"host in/out, {name} piece loop ({n} px, {bytes_in / 1e6:.0f} MB in, "
            f"{bytes_out / 1e6:.0f} MB out): {json.dumps(out[name])}")
    return out


def streaks_profile(torch, out_dir, tile=4096, win=40, reps=5):
    """The phase-10 single-scale call: a profile, and its stages from CUDA
    events with the bytes each must move as its bound."""
    from xsarsea_tpu_torch import gradients as G
    from xsarsea_tpu_torch.scripts import cuda_ms

    img = torch.as_tensor(synthetic_tile(tile, tile, 1), device="cuda")
    centers = torch.arange(win // 2, tile // 4 - win // 2, win, device="cuda")
    bins = torch.as_tensor(G._angle_bin_centers(72).astype(np.float32), device="cuda")

    def once():
        out = G.streaks_histogram_core(img, centers, centers, win, bins)
        torch.cuda.synchronize()
        return out

    once()
    prof = profile_call(torch, once, out_dir, "profile_table_streaks.txt")
    lg = G._streaks_lg(img)
    stack = torch.stack(lg)
    w3 = G._extract_windows(stack, centers, centers, win, win)
    planes = [w3[:, k, :] for k in range(3)]
    vals = torch.where(planes[0] > 0, planes[0], torch.full_like(planes[0], float("inf")))
    f32 = 4
    lg_px, win_px = lg[0].numel(), planes[0].numel()
    stages = {
        "stencil cascade (_streaks_lg)": (lambda: G._streaks_lg(img),
                                          img.numel() * f32 + 3 * lg_px * f32),
        "window gather (stack + _extract_windows)": (
            lambda: G._extract_windows(torch.stack(lg), centers, centers, win, win),
            2 * 3 * win_px * f32),
        "median sort (torch.sort of the rows)": (lambda: torch.sort(vals, dim=1),
                                                 2 * win_px * f32),
        "weights and histogram (_histogram_windows)": (
            lambda: G._histogram_windows(*planes, bins, total=win * win),
            3 * win_px * f32 + planes[0].shape[0] * 72 * f32),
    }
    table = {name: {"ms": cuda_ms(fn, reps), "bytes": nbytes,
                    "bound_ms": nbytes / PEAK_BYTES * 1e3} for name, (fn, nbytes) in stages.items()}
    hist = table["weights and histogram (_histogram_windows)"]
    hist["ms_without_its_sort"] = hist["ms"] - table["median sort (torch.sort of the rows)"]["ms"]
    total = sum(row["ms"] for name, row in table.items() if "median sort" not in name)
    for name, row in table.items():
        row["share_of_stages"] = row["ms"] / total
        row["bound_share"] = row["bound_ms"] / row["ms"]
    whole = cuda_ms(lambda: G.streaks_histogram_core(img, centers, centers, win, bins), reps)
    out = {"profile": prof, "stages": table, "stages_sum_ms": total, "whole_call_ms": whole,
           "windows": planes[0].shape[0], "window_px": planes[0].shape[1]}
    log(f"streaks_histogram_core ({tile} x {tile} px f32, device-resident): {json.dumps(out)}")
    return out


def run(out_dir, n=1 << 23, n_cmp=1 << 20, reps=9):
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from xsarsea_tpu_torch.bench import make_scene
    from xsarsea_tpu_torch.models import get_model
    from xsarsea_tpu_torch.ops import inversion_kernels as K
    from xsarsea_tpu_torch.windspeed.inversion import prepare_tables

    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(card)
    K.build_kernels()
    sc = make_scene(n, device="cuda")
    tables = prepare_tables(*MODELS, dtype=torch.float32)
    dev = to_device(torch, sc["inc"], sc["s0_co_db"], sc["s0_cr_db"], sc["dsig_cr"], sc["anc"])
    prof, rate = profile_and_rate(torch, tables, dev, out_dir, "profile_table.txt", reps,
                                  "fused tail")

    bench = compare(torch, tables, sc["inc"][:n_cmp], sc["s0_co_db"][:n_cmp],
                    sc["s0_cr_db"][:n_cmp], sc["dsig_cr"][:n_cmp], sc["anc"][:n_cmp])
    log(f"fused vs exact, bench scene first {n_cmp} px: {json.dumps(bench)}")
    off = {}
    for seed in (7, 8):
        off[seed] = compare(torch, tables, *off_gmf_scene(n_cmp, seed))
        log(f"fused vs exact, off-GMF seed {seed}: {json.dumps(off[seed])}")

    # the unfused tail: K1, K3, K4 on the phase-7 pair of chip_smoke.py
    with tempfile.TemporaryDirectory() as tmp:
        tables_u, _, s0_cr_db_u = unfused_pair(sc, Path(tmp))
    dev = to_device(torch, sc["inc"], sc["s0_co_db"], s0_cr_db_u, sc["dsig_cr"], sc["anc"])
    prof_u, rate_u = profile_and_rate(torch, tables_u, dev, out_dir,
                                      "profile_table_unfused.txt", reps, "unfused tail")
    del dev
    bench_u = compare(torch, tables_u, sc["inc"][:n_cmp], sc["s0_co_db"][:n_cmp],
                      s0_cr_db_u[:n_cmp], sc["dsig_cr"][:n_cmp], sc["anc"][:n_cmp])
    log(f"unfused tail: fused vs exact, bench scene first {n_cmp} px: {json.dumps(bench_u)}")

    # scene preparation and the inversion through the xarray bridge (phase 9, steps 1-2)
    ds, _ = prep_scene(torch, get_model, 2048, 4096, 0)
    seconds = {}

    def prep_once():
        winds = invert_labelled(ds, prepare_scene(torch, ds, seconds))
        torch.cuda.synchronize()
        return winds

    prep_once()
    prof_p = profile_call(torch, prep_once, out_dir, "profile_table_scene_prep.txt")
    prof_p["step_seconds"] = dict(seconds)
    log(f"scene preparation + invert_from_model ({ds['inc'].size} px, host arrays in and out): "
        f"{json.dumps(prof_p)}")

    inout = host_in_out(torch, sc, out_dir)
    streaks = streaks_profile(torch, out_dir)

    summary = {"card": card, "profile": prof, "rate": rate, "bench_parity": bench,
               "off_gmf_parity": off,
               "unfused": {"profile": prof_u, "rate": rate_u, "bench_parity": bench_u},
               "scene_prep": prof_p, "host_in_out": inout, "streaks": streaks}
    if out_dir is not None:
        (out_dir / "chip_profile.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for the profiler table and the JSON summary")
    sys.exit(run(parser.parse_args().out))
