"""Scaling harness of the device mesh: weak scaling and bucket balance.

Port of ``scripts/bench_scaling.py``, parts 1 and 2:

1. **Weak scaling** of ``parallel.sharded_invert_pixels``: a fixed number of
   pixels a mesh entry, meshes of 1, 2, 4 and 8 entries along ``data``. On
   the CPU the entries are ``"cpu"`` repeated, on the card ``"cuda:0"``
   repeated: one device under every entry, so this checks the layout (one
   host thread a distinct device, shards split and joined) and prices its
   overhead; it is no rate across cards. The tables are the JAX script's
   (``gmf_cmod5n``/``gmf_s1_v2`` at incidence 1 deg, speed 0.5 m/s,
   direction 5 deg), mode ``auto`` (``fused`` on a card, ``exact`` on the
   CPU). All counts run in this one process: the port's mesh needs no
   subprocess a device count, as JAX's virtual device count does.
2. **Bucket load balance** of ``bucket_by_band`` under data sharding: each
   shard buckets its own pixels, so its blocks holding a pixel are the
   blocks its kernels sweep (the rest of the fixed-size grid is padding they
   skip); reported as min/max/mean blocks a shard and the max/mean imbalance
   over 8 shards, for a smooth-incidence EW scene (rows in order) and for
   its worst case (pixels sorted by incidence).

Part 3 of the JAX script, the Mosaic-compiled ``shard_map`` + ``pallas_call``
smoke on a TPU, has no counterpart here: ``chip_smoke.py`` phase 11 drives
the port's mesh on the card with its kernels.

Run: ``python -m xsarsea_tpu_torch.scripts.bench_scaling`` on the card;
:func:`main` with ``device="cpu"`` (and a small ``n``) on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from xsarsea_tpu_torch.ops.bucketing import bucket_by_band
from xsarsea_tpu_torch.parallel import make_mesh, sharded_invert_pixels
from xsarsea_tpu_torch.scripts import device_of
from xsarsea_tpu_torch.windspeed import prepare_tables

N = 1 << 23
COUNTS = (1, 2, 4, 8)
TABLE_KWARGS = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)


def weak_scaling(device, counts, px_per_entry, reps=3, log=print):
    """Best-of-``reps`` seconds of ``sharded_invert_pixels`` at each mesh
    size, ``px_per_entry`` pixels an entry (seed 0, the JAX script's
    random scene)."""
    name = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=dtype, **TABLE_KWARGS)
    rows = []
    for d in counts:
        mesh = make_mesh(d, 1, devices=[name] * d)
        n = px_per_entry * d
        rng = np.random.default_rng(0)
        args = (rng.uniform(19.0, 45.0, n), rng.uniform(-30.0, -5.0, n),
                rng.uniform(-40.0, -20.0, n), np.full(n, 0.1),
                rng.uniform(2.0, 20.0, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n)))
        sharded_invert_pixels(tables, *args, mesh=mesh, mode="auto")  # warm-up
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            sharded_invert_pixels(tables, *args, mesh=mesh, mode="auto")
            best = min(best, time.perf_counter() - t0)
        rows.append({"entries": d, "px": n, "step_s": best})
    base = rows[0]["step_s"]
    log(f"weak scaling, {px_per_entry} px an entry, mesh entries all {name} (a layout check, "
        "not a rate across devices):")
    log("| entries | total px | step (s) | vs 1 entry | Mpx/s |")
    log("|---|---|---|---|---|")
    for r in rows:
        log(f"| {r['entries']} | {r['px']} | {r['step_s']:.4f} | {r['step_s'] / base:.2f}x "
            f"| {r['px'] / r['step_s'] / 1e6:.3f} |")
    return rows


def bucket_balance(device, n, n_shards=8, block=128, n_bands=501, log=print):
    """Blocks holding a pixel, a shard, after ``bucket_by_band`` on each
    shard's own pixels."""
    rng = np.random.default_rng(0)
    nx = min(8192, n)
    inc = np.tile(np.linspace(19.0, 47.0, nx), n // nx) + rng.normal(0, 0.05, n // nx * nx)
    bands = np.clip(((inc - 16.0) / 0.1).round().astype(np.int64), 0, n_bands - 1)
    out = {}
    for name, order in (("row-major (realistic)", slice(None)),
                        ("sorted by incidence (worst case)", np.argsort(inc, kind="stable"))):
        work = []
        for shard in np.array_split(bands[order], n_shards):
            perm, _ = bucket_by_band(torch.as_tensor(shard, device=device), n_bands, block)
            work.append(int((perm.reshape(-1, block) >= 0).any(dim=1).sum()))
        out[name] = work
        log(f"  {name}: blocks/shard min={min(work)} max={max(work)} "
            f"mean={np.mean(work):.0f} imbalance={max(work) / np.mean(work):.3f}")
    return out


def main(n=N, device="cuda", counts=COUNTS, log=print):
    """Part 2 on ``n`` pixels over 8 shards, then part 1 at ``n // 32``
    pixels a mesh entry (262,144 at the default, the JAX script's)."""
    dev = device_of(device)
    log(f"bucket load balance (8 shards, {n} px, 0.1 deg incidence grid), device {dev}:")
    balance = bucket_balance(dev, n, log=log)
    weak = weak_scaling(dev, counts, n // 32, log=log)
    return {"balance": balance, "weak": weak}


if __name__ == "__main__":
    main()
