"""Per-stage budget of the streaks histogram core (BASELINE config #4).

Port of ``scripts/bench_streaks_stages.py``. Decomposes
``gradients.streaks_histogram_core`` on the benchmark's 4,096² tile (the
JAX package's ``_synthetic_tile``: ``sin(0.35 (x + 0.6 y))`` under N(0, 0.1)
noise; 40-px windows on the local-gradient grid, 72 bins) into its stages
and times each with CUDA events, median of 3 after a warm-up:

* the whole core;
* A: the first R2 reduction and the square root;
* B: the local-gradient cascade (Scharr stencils and three R2 reductions,
  ``_lg_arrays``), and A+B as ``_streaks_lg``;
* C: the stacked window extraction (one gather for the three channels);
* D: the histogram (``_histogram_windows``: masked median sort, weights,
  ``index_add_``), then its parts: D1 the masked sort alone, D2 everything
  but the sort (the median replaced by a mean), D3 the ``index_add_`` binning
  alone.

The JAX script's retired forms become the port's alternatives where one
exists: D3' bins by a one-hot broadcast-reduce (the JAX package's production
form, which the port replaced by ``index_add_``), and C' extracts the three
channels in three gathers (the JAX package's retired per-channel form). Its
one-hot matmul histogram (D4) is left out: on the card a matmul of one-hot
operands runs on the tensor cores in TF32 or lower unless forbidden, and the
port's histograms are float32 or float64 sums, so it is no candidate here.
The stage sum exceeds the core: each stage timed alone pays its own launches.

Run: ``python -m xsarsea_tpu_torch.scripts.bench_streaks_stages`` on the
card; :func:`main` with ``device="cpu"`` (and a small ``side``) on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch import gradients as G
from xsarsea_tpu_torch.ops.conv2d import r2_reduce
from xsarsea_tpu_torch.scripts import device_of, median_ms

SIDE = 4096
WINDOW = 40


def synthetic_tile(ny, nx, seed):
    """The JAX package benchmark's streak tile (``bench._synthetic_tile``)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256]
    tile = 1.0 + 0.5 * np.sin(0.35 * (x + 0.6 * y))
    return np.abs(np.tile(tile, (ny // 256, nx // 256))
                  + 0.1 * rng.normal(size=(ny, nx))).astype(np.float32) + 0.01


def _bin_index(ang, bins):
    k = torch.round((ang - bins[0]) / (bins[1] - bins[0]))
    return torch.where(torch.isnan(k), torch.zeros_like(k), k).clamp(
        0, bins.shape[0] - 1).to(torch.int64)


def main(side=SIDE, device="cuda", reps=3, log=print):
    """Time the stages on a ``side`` x ``side`` tile; returns ``{"px",
    "stages": [(name, ms), ...]}``."""
    dev = device_of(device)
    win = WINDOW
    n_lg = side // 4
    centers = torch.as_tensor(np.arange(win // 2, n_lg - win // 2, win), device=dev)
    bins = torch.as_tensor(G._angle_bin_centers(72).astype(np.float32), device=dev)
    img = torch.as_tensor(synthetic_tile(side, side, seed=1), device=dev)
    px = side * side
    log(f"input {side}x{side} | win {win} | {len(centers)}^2 windows | device {dev}")
    stages = []

    def stage(name, fn):
        out, ms = median_ms(fn, dev, reps)
        stages.append((name, ms))
        log(f"{name:44s} {ms:9.3f} ms  {px / ms / 1e3:10.1f} Mpx/s")
        return out

    stage("core: streaks_histogram_core",
          lambda: G.streaks_histogram_core(img, centers, centers, win, bins))
    ampl = stage("A  r2_reduce(img) + sqrt", lambda: torch.sqrt(r2_reduce(img)))
    lg = stage("B  _lg_arrays (scharr + 3 x r2)", lambda: G._lg_arrays(ampl))
    stage("A+B _streaks_lg", lambda: G._streaks_lg(img))
    g2_abs, g2_angle, c = lg[3], lg[4], lg[5]
    w3 = stage("C  _extract_windows stacked x3", lambda: G._extract_windows(
        torch.stack([g2_abs, g2_angle, c]), centers, centers, win, win))
    stage("C' per-channel extraction x3", lambda: [
        G._extract_windows(a, centers, centers, win, win) for a in (g2_abs, g2_angle, c)])
    aw, gw, qw = w3[:, 0, :], w3[:, 1, :], w3[:, 2, :]
    stage("D  _histogram_windows (sort + index_add_)",
          lambda: G._histogram_windows(aw, gw, qw, bins, total=win * win))
    stage("D1 masked sort alone", lambda: torch.sort(torch.where(
        (~torch.isnan(aw)) & (aw > 0), aw, torch.full((), float("inf"), device=dev)), dim=1))

    def no_sort():
        mask = (~torch.isnan(aw)) & (aw > 0)
        med = torch.nanmean(torch.where(mask, aw, float("nan")), dim=1)
        w = aw / (aw + med[:, None]) * qw
        wm = torch.where(mask & ~torch.isnan(w), w, torch.zeros_like(w))
        flat = (torch.arange(aw.shape[0], device=dev)[:, None] * 72 + _bin_index(gw, bins))
        hist = torch.zeros(aw.shape[0] * 72, dtype=wm.dtype, device=dev)
        return hist.index_add_(0, flat.reshape(-1), wm.reshape(-1)), mask.sum(dim=1)

    stage("D2 histogram with a mean for the median", no_sort)
    wq = torch.where(torch.isnan(qw), torch.zeros_like(qw), qw)
    ki = _bin_index(gw, bins)
    flat = (torch.arange(aw.shape[0], device=dev)[:, None] * 72 + ki).reshape(-1)
    stage("D3 index_add_ binning alone", lambda: torch.zeros(
        aw.shape[0] * 72, dtype=wq.dtype, device=dev).index_add_(0, flat, wq.reshape(-1)))
    stage("D3' one-hot broadcast-reduce binning", lambda: torch.where(
        ki[:, :, None] == torch.arange(72, device=dev), wq[:, :, None],
        torch.zeros((), dtype=wq.dtype, device=dev)).sum(dim=1))
    return {"px": px, "stages": stages}


if __name__ == "__main__":
    main()
