#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs a CUDA
device and ``nvcc``, and imports nothing of JAX. Phases, each printed as
it finishes; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the inversion kernels from ``xsarsea_tpu_torch/ops/csrc``;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   on the high-resolution LUTs and a 64 Kpx bucketed subsample of the scene;
4. the main path: dual-pol ``invert_from_model`` with models
   (gmf_cmod5n, gmf_s1_v2) on a 2**23-pixel seed-0 scene forward-modelled
   with the port's GMFs, checking that both kernels were launched, plus the
   speed RMS against the true wind over the first 2**20 pixels;
5. ``invert_pixels`` on device-resident float32 inputs, median of 3 timed
   runs after a warm-up; then, on the arguments the main path gave each
   kernel (one 2**22-pixel piece), the kernel against its plain version bit
   for bit, and the time of each;
6. fused against exact, both on the card, on the first 2**16 pixels.

The second-to-last line is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def captured_calls(K):
    """Record the last arguments each kernel wrapper was called with."""
    calls = {}
    originals = {name: getattr(K, name) for name in K.KERNELS}

    def recorder(name, fn):
        def record(*args, **kwargs):
            calls[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return record

    for name, fn in originals.items():
        setattr(K, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)


def plain_version(K, name):
    return {"group_argmin": K._group_argmin_plain,
            "slab_refine_fused": K._slab_refine_fused_plain}[name]


def hold_against_plain(torch, K, name, args, kwargs, phase):
    """Run kernel ``name`` and its plain version on the same arguments;
    exit unless they are bit-equal. Returns (max abs error, output size)."""
    got = getattr(K, name)(*args, **kwargs)
    ref = plain_version(K, name)(*args, **kwargs, chunk_blocks=128)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.equal(got, ref):
        bad = int((got != ref).sum()) if got.shape == ref.shape else "all"
        raise SystemExit(f"{phase}: {name} differs from its plain version on {bad} "
                         f"of {ref.numel()} outputs")
    return float((got.double() - ref.double()).abs().max()), ref.numel()


def feats_of(name, args):
    return args[4 if name == "group_argmin" else 7]


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_scene(torch, get_model, n, seed=0):
    """The benchmark scene: uniform incidence, speed and direction, sigma0
    forward-modelled (float64, on the card) and a noisy ancillary wind."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    dev = [torch.as_tensor(a, device="cuda") for a in (inc, wspd, phi)]
    s0_co = get_model("gmf_cmod5n")(*dev, broadcast=True).cpu().numpy()
    s0_cr = get_model("gmf_s1_v2")(dev[0], dev[1], broadcast=True).cpu().numpy()
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    return dict(inc=inc, wspd=wspd, s0_co=s0_co, s0_cr=s0_cr, anc=anc,
                s0_co_db=10 * np.log10(s0_co + 1e-15), s0_cr_db=10 * np.log10(s0_cr + 1e-15),
                dsig_cr=np.full(n, 0.1))


def cost_gaps(torch, tables, inc, s0_db, anc, wind, dsig_co=0.1, chunk=256):
    """Exact-form f32 copol cost at the LUT cell of each output wind minus
    the minimum of the pixel's cost plane; returns (gap, minimum) arrays."""
    from xsarsea_tpu_torch.windspeed.inversion import _nearest_index

    t = tables.to("cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    gaps, mins = [np.zeros(0, np.float32)], [np.zeros(0, np.float32)]
    for lo in range(0, len(inc), chunk):
        sl = slice(lo, lo + chunk)
        ii = _nearest_index(t.co_inc, torch.as_tensor(inc[sl], **f32))
        ma = torch.as_tensor(anc[sl].real, **f32)
        mz = torch.as_tensor(anc[sl].imag, **f32)
        phi = torch.as_tensor(np.angle(wind[sl]), **f32)
        if t.phi_180:
            mz, phi = mz.abs(), phi.abs()
        else:
            phi = torch.remainder(phi, 2 * np.pi)
        s0 = torch.as_tensor(s0_db[sl], **f32)
        j = ((t.co_u - ma[:, None, None]) / 2.0) ** 2 \
            + ((t.co_v - mz[:, None, None]) / 2.0) ** 2 \
            + ((t.co_lut[ii] - s0[:, None, None]) / dsig_co) ** 2
        iw = _nearest_index(t.co_wspd, torch.as_tensor(np.abs(wind[sl]), **f32))
        ip = _nearest_index(t.co_phir, phi)
        jmin = j.reshape(j.shape[0], -1).amin(1)
        gaps.append((j[torch.arange(j.shape[0], device="cuda"), iw, ip] - jmin).cpu().numpy())
        mins.append(jmin.cpu().numpy())
    return np.concatenate(gaps), np.concatenate(mins)


def run(n=1 << 23, n_sub=1 << 16, n_rms=1 << 20, reps=3):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xsarsea_tpu_torch.models import get_model
    from xsarsea_tpu_torch.ops import inversion_kernels as K
    from xsarsea_tpu_torch.windspeed.inversion import (invert_from_model, invert_pixels,
                                                       prepare_tables)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = ("gmf_cmod5n", "gmf_s1_v2")
    sources = {"group_argmin": ("xsarsea_tpu_torch/ops/csrc/group_argmin.cu",
                                "xsarsea_tpu/ops/pallas_inversion.py:467"),
               "slab_refine_fused": ("xsarsea_tpu_torch/ops/csrc/slab_refine_fused.cu",
                                     "xsarsea_tpu/ops/pallas_inversion.py:1030")}
    report = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep}
              for name, (src, rep) in sources.items()}

    # phase 1: the card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log("phase 1 card (nvidia-smi name, power.limit):")
    log(card)

    # phase 2: kernel build
    t0 = time.perf_counter()
    lib = K.build_kernels()
    log(f"phase 2 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in K.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    sc = make_scene(torch, get_model, n)
    tables = prepare_tables(*models, dtype=torch.float32)
    log(f"scene ({n} px) and high-res tables {tables.co_lut.shape} + {tables.cr_lut.shape} "
        f"in {time.perf_counter() - t0:.1f} s")

    def dev_inputs(lo, hi):
        f32 = dict(dtype=torch.float32, device="cuda")
        return (torch.as_tensor(sc["inc"][lo:hi], **f32),
                torch.as_tensor(sc["s0_co_db"][lo:hi], **f32),
                torch.as_tensor(sc["s0_cr_db"][lo:hi], **f32),
                torch.as_tensor(sc["dsig_cr"][lo:hi], **f32),
                torch.as_tensor(sc["anc"][lo:hi].astype(np.complex64), device="cuda"))

    # phase 3: kernels against their plain versions, bit for bit
    with captured_calls(K) as calls:
        invert_pixels(tables, *dev_inputs(0, n_sub), mode="fused", device="cuda")
    for name, (args, kwargs) in calls.items():
        err, size = hold_against_plain(torch, K, name, args, kwargs, "phase 3")
        report[name]["max_abs_err"] = err
        log(f"phase 3 {name}: bit-equal to its plain version on {size} outputs "
            f"(feats {tuple(feats_of(name, args).shape)})")

    # phase 4: the main path, with launch counts
    K.reset_launch_counts()
    t0 = time.perf_counter()
    wind_co, wind_dual = invert_from_model(
        sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"], dsig_co=0.1,
        dsig_cr=0.1, model=models, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    for name, count in launches.items():
        if count == 0:
            raise SystemExit(f"phase 4: kernel {name} was not launched by the main path")
        report[name]["launches"] = count
    for name, w in (("wind_co", wind_co), ("wind_dual", wind_dual)):
        if w.shape != (n,) or not np.isfinite(w).all():
            raise SystemExit(f"phase 4: {name} has shape {w.shape} or non-finite values")
    co, dual = invert_pixels(tables, sc["inc"][:n_rms], sc["s0_co_db"][:n_rms],
                             sc["s0_cr_db"][:n_rms], sc["dsig_cr"][:n_rms], sc["anc"][:n_rms],
                             mode="fused", device="cuda")
    rms = float(np.sqrt(np.nanmean((np.abs(dual) - sc["wspd"][:n_rms]) ** 2)))
    rms_merged = float(np.sqrt(np.mean((np.abs(wind_dual[:n_rms]) - sc["wspd"][:n_rms]) ** 2)))
    log(f"phase 4 invert_from_model: {n} px in {seconds:.2f} s (host in/out, tables cached), "
        f"launches {launches}, rms_vs_truth_noisy_m_s {rms:.6f} "
        f"(merged dual output: {rms_merged:.6f})")
    if not 0.341 <= rms <= 0.351:
        raise SystemExit(f"phase 4: rms_vs_truth_noisy_m_s {rms} outside 0.346 +- 0.005")

    # phase 5: device-resident rate, and each kernel beside its plain version
    dev = dev_inputs(0, n)

    def once():
        out = invert_pixels(tables, *dev, mode="fused", device="cuda", device_output=True)
        torch.cuda.synchronize()
        return out

    with captured_calls(K) as calls:
        once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    rate = n / statistics.median(times) / 1e6
    log(f"phase 5 invert_pixels device-resident f32: {rate:.3f} Mpx/s "
        f"(median of {reps}: {[round(t, 4) for t in times]} s for {n} px)")
    for name, (args, kwargs) in calls.items():
        err, size = hold_against_plain(torch, K, name, args, kwargs, "phase 5")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        report[name]["ms"] = cuda_ms(torch, lambda: getattr(K, name)(*args, **kwargs), 5)
        report[name]["plain_ms"] = cuda_ms(
            torch, lambda: plain_version(K, name)(*args, **kwargs, chunk_blocks=128), 1)
        log(f"phase 5 {name}: bit-equal to its plain version on {size} outputs at the main "
            f"path's shapes (feats {tuple(feats_of(name, args).shape)}); kernel "
            f"{report[name]['ms']:.3f} ms, plain {report[name]['plain_ms']:.3f} ms per call")

    # phase 6: fused against exact on the card
    fused = invert_pixels(tables, *dev_inputs(0, n_sub), mode="fused", device="cuda")
    exact = invert_pixels(tables, *dev_inputs(0, n_sub), mode="exact", device="cuda",
                          chunk_size=1024)
    differ = np.zeros(n_sub, bool)
    dev_max = 0.0
    for f, e in zip(fused, exact):
        differ |= ~((f == e) | (np.isnan(f) & np.isnan(e)))
        dev_max = max(dev_max, float(np.nanmax(np.abs(np.abs(f) - np.abs(e)))))
    log(f"phase 6 fused vs exact on {n_sub} px: {int(differ.sum())} differing pixels, "
        f"cuda_vs_exact_max_dev_m_s {dev_max}")
    idx = np.nonzero(differ)[0][:10]
    gaps, _ = cost_gaps(torch, tables, sc["inc"][idx], sc["s0_co_db"][idx], sc["anc"][idx],
                        fused[0][idx])
    for i, gap in zip(idx, gaps):
        log(f"  pixel {i}: fused {fused[0][i]:.6f} exact {exact[0][i]:.6f}, "
            f"exact-form cost gap {gap:.3e}")

    log(json.dumps({"kernels": list(report.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
