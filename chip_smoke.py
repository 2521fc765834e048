#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs a CUDA
device and ``nvcc``, and imports nothing of JAX. Phases, each printed as
it finishes; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the inversion kernels from ``xsarsea_tpu_torch/ops/csrc``;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   on the high-resolution LUTs and a 64 Kpx bucketed subsample of the scene;
   then K2 and K3 on the seam cases of their slab sweep
   (``xsarsea_tpu_torch/ops/slab_seams.py``: ties across its warps, chunks
   and float4s, padding groups, NaN and infinite operands) at the LUT's
   width, bit for bit and at their designed answers; K1, K4 and K2's
   crosspol tail on theirs (``xsarsea_tpu_torch/ops/coarse_seams.py``) at
   the path's widths (46 coarse columns; 155 and 771 crosspol entries),
   likewise; and the crosspol loop's hoisted quotient against the true
   divide, bit for bit, on 2**26 random bit patterns, 2**26 pairs inside
   its windows and an edge set with the crosspol LUT's own differences;
4. the main path: dual-pol ``invert_from_model`` with models
   (gmf_cmod5n, gmf_s1_v2) on a 2**23-pixel seed-0 scene forward-modelled
   with the port's GMFs, checking that both kernels were launched, plus the
   speed RMS against the true wind over the first 2**20 pixels;
5. ``invert_pixels`` on device-resident float32 inputs, median of 3 timed
   runs after a warm-up; then, on the arguments the main path gave each
   kernel (one 2**22-pixel piece), the kernel against its plain version bit
   for bit, and the time of each;
6. fused against exact, both on the card, on the first 2**16 pixels;
7. the unfused tail: LUT-file models ``gmf_cmod7`` (the KNMI fixture,
   high-res 501 x 499 x 181) and ``sarwing_lut__fix_cr_2_1`` (the sarwing
   crosspol fixture, 67 x 155 on its own incidence axis), registered from
   ``tests/data``; dual-pol ``invert_from_model`` on the same scene (crosspol
   sigma0 interpolated from the crosspol LUT) must launch K1, K3 and K4 and
   not K2; then the device-resident rate, K3 and K4 against their plain
   versions on a 64 Kpx subsample and on one 2**22-pixel piece's arguments,
   with their times, and fused against exact on the first 2**16 pixels;
8. the experiment drivers of ``xsarsea_tpu_torch/scripts``: the slab
   sweep's three cost forms (K5) on a 2**23-pixel scene bucketed by the
   port's stage 1, with their times and argmin flips against the direct
   form, and the coarse pass's nine expanded-form variants (K6) at 2**23
   pixels; each form and variant must have been launched by its driver and
   be bit-equal to its plain version on the driver's arguments, and the
   direct form (one pixel a thread, the loop K2 and K3 had before their
   redesign) bit-equal to K3, whose time on the same arguments is printed
   beside it;
9. scene preparation around the inversion, on a labelled scene of 2,048
   lines x 4,096 samples built in memory from ``--seed`` (incidence rising
   along the sample axis over 18-47 deg, NESZ rising with incidence with a
   few NaNs, a NaN land patch in copol sigma0, ECMWF speed and meteorological
   direction, a heading): ``dir_meteo_to_sample`` into a complex ancillary
   wind, ``nesz_flattening``, ``get_dsig("gmf_s1_v2", ...)`` and
   ``sigma0_detrend`` with ``gmf_cmod5n`` on DimArrays with
   ``device="cuda"``; then dual-pol ``invert_from_model`` with that per-pixel
   ``dsig_cr`` array through the xarray bridge, on inputs of a small
   DataArray-like class defined here, which must launch K1 and K2, return
   that class with ``("line", "sample")`` dims and ``model``/``comment``
   attrs, give NaN copol and finite dual-pol wind over land and a dual-pol
   speed within 1.0 m/s RMS of the true wind; then ``nesz_flattening``,
   ``get_dsig`` and ``sigma0_detrend`` on the card against ``device="cpu"``
   in float64 on a 256-line strip (rtol 1e-9, 1e-12 and 1e-11), the float32
   line fit's deviation from float64, and ``sigma0_detrend`` on a chunked
   sigma0, bit-equal to the eager result. Each step prints its seconds;
10. the wind streaks (Koch 2004), through ``xsarsea_tpu_torch.gradients``,
    which holds no hand kernel (plain PyTorch calls, as the JAX package has
    no Pallas kernel there): ``streaks_histogram_core`` on a device-resident
    4,096 x 4,096 float32 tile of streaks ``sin(0.35 (x + 0.6 y))`` under
    noise, 625 windows of 40 x 40 local-gradient pixels, 72 bins, median of
    3 timed runs after a warm-up; ``Gradients(...).histogram`` with window
    sizes 1,600 and 3,200 m and downscale factors 1 and 2 on 2 x 2,048 x
    2,048 px at 10 m, construction included, the fused result against the
    per-instance path; ``Gradients2D`` on a scene of 8,192 x 16,384 px
    (2**27, a Sentinel-1 IW GRD's order) that exists only as a row
    generator, streamed in bands of at most 2**25 px, with its seconds, the
    generator's share of them and the largest single request, and on a
    4,096-row strip of it against the same strip in memory. Gates: the card
    against ``device="cpu"`` in float64 on a 512 x 512 crop (local gradients
    1e-11 relative to the largest value, histograms rtol 1e-9 with atol
    1e-12), float32 on the card against float64 (weight within 1e-3), the
    stencils and resamplings in float32 within 1e-5 of float64 with TF32
    allowed by the caller, the peak of the mean histogram within one 2.5 deg
    bin of the streaks' gradient direction ``atan2(0.6, 1)``, ``used_ratio``
    1.0 for interior windows and no non-finite weight;
11. the ``fused_exact`` mode (K1 on the full 499 x 181 grid in its streamed
    form, K2 or K3 on a 32-row slab): ``invert_pixels(mode="fused_exact")``
    on phase 5's scene, device-resident, median of 3 after a warm-up, which
    must launch the streamed K1 and K2, and on one 2**22-pixel piece of
    phase 7's own-axes tables, which must launch the streamed K1, K3 and K4;
    each form against its plain version on a 64 Kpx subsample, on the seam
    cases (``coarse_seams`` at 181 columns, ``slab_seams`` at 32 rows) and
    on one piece's arguments, with its times and bound; ``fused_exact``
    against ``exact`` on 2**16 px, and ``fused`` against ``fused_exact`` on
    2**20 px, which must not differ. Then the margin sweep
    (``xsarsea_tpu_torch/scripts/sweep_margin.py``) at its default
    configuration and two others on 2**22 adversarial pixels;
    ``parallel.invert_scenes`` on four scenes of different shapes (~2**24 px)
    with phase 7's tables, no mesh, from host arrays, each scene bit-equal to
    ``invert_pixels``; and a mesh naming the card twice:
    ``sharded_invert_pixels`` in ``fused`` mode (data 2) and ``exact`` mode
    (model 2) bit-equal to one device on 2**16 px, ``sharded_streaks_histogram``
    (data 2) on phase 10's tile against the one-device core;
12. the port's remaining entry points: (a) ``xsarsea-tpu-torch invert``
    (``xsarsea_tpu_torch.cli``) with its defaults (the card, mode auto) on
    phase 4's scene written as a directory of ``.npy`` files, dual-pol and
    mono-pol, each launching K1 and K2 and bit-equal to ``invert_from_model``
    on the same memmaps, then ``list``; (b) ``utils.trace`` around one
    2**22-px device-resident call, whose trace file must name K1's and K2's
    kernels; (c) the full-scene demo (``scripts/demo_full_scene.py``) at its
    default 10**8 px from a temporary directory: build and inversion seconds,
    Mpx/s from disk, the Python-allocated peak, the pinned pool, the dual-pol
    RMS against the truth (gates: finite and < 1.0 m/s, temporaries below the
    outputs' bytes); (d) ``PlotGradients(hist).peak`` on phase 10's class
    histogram in float64, card against ``device="cpu"``: angles equal outside
    windows whose two largest weights are within 1e-9 relative (the card's
    histogram sums atomically), weights to rtol 1e-9; (e) the four stage and
    scaling scripts at their defaults (``bench_stages``, ``bench_streaks_stages``,
    ``bench_gather_sizes``, ``bench_scaling``), printing their tables; (f) the
    seven examples, ``main()`` each on the card, with their own gates.

Phases 4 and 9 run ``invert_from_model`` through the overlapped piece loop
(preparation, kernels and result copies of neighbouring pieces at once,
through pinned buffers) and again through the serial loop: the two results
must be bit-equal, and both times are printed.

``python3 chip_smoke.py --through N`` (N from 3 to 11) stops after phase N,
for a quicker look at the phases before it while a kernel is being worked
on; it prints neither of the two result lines below, which only a whole run
earns.

Each phase prints its seconds. The second-to-last line is a JSON object
describing each kernel (each K5 form and K6 variant apart): its time and
its plain version's on the path's arguments, its launches, and its bound,
the least time the card could take for the same work (the larger of the
bytes each input and output must move over 3.35 TB/s and the operations,
counted from the kernel's code per entry for the path's real pixels, over
67 TFLOP/s FP32, or 989 TFLOP/s for K6's bf16 products; NVIDIA's H100 SXM
data sheet at 700 W). No single PyTorch call computes any of these
functions (each is an argmin over a cost), so ``library_ms`` is null. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gzip
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


DATA = Path(__file__).resolve().parent / "tests" / "data"
KERNELS = {  # name: (source, TPU kernel it replaces, position of the feats argument)
    "group_argmin": ("xsarsea_tpu_torch/ops/csrc/group_argmin.cu",
                     "xsarsea_tpu/ops/pallas_inversion.py:467", 4),
    "group_argmin_streamed": ("xsarsea_tpu_torch/ops/csrc/group_argmin.cu",
                              "xsarsea_tpu/ops/pallas_inversion.py:467", 4),
    "slab_refine_fused": ("xsarsea_tpu_torch/ops/csrc/slab_refine_fused.cu",
                          "xsarsea_tpu/ops/pallas_inversion.py:1030", 7),
    "slab_refine": ("xsarsea_tpu_torch/ops/csrc/slab_refine.cu",
                    "xsarsea_tpu/ops/pallas_inversion.py:835", 3),
    "crosspol_argmin": ("xsarsea_tpu_torch/ops/csrc/crosspol_argmin.cu",
                        "xsarsea_tpu/ops/pallas_inversion.py:667", 2),
}
UNFUSED_MODELS = ("gmf_cmod7", "sarwing_lut__fix_cr_2_1")  # phase 7: own incidence axes
EXPERIMENTS = {  # phase 8: kernel family -> (source, TPU kernel it replaces)
    "slab_forms": ("xsarsea_tpu_torch/ops/csrc/slab_forms.cu", "scripts/bench_slab_forms.py:141"),
    "group_argmin_variant": ("xsarsea_tpu_torch/ops/csrc/group_argmin_variants.cu",
                             "scripts/bench_kernel_variants.py:74"),
}

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# FP32 operations per cost entry, counted from the kernels' code: the cost
# (inversion_common.cuh) plus the compare that keeps the minimum
OPS_DIRECT = 10  # 3 sub, 4 mul, 2 add, compare (K1, K2, K3, K5 direct)
OPS_FORM = {"direct": OPS_DIRECT, "prescaled": 9, "expanded_uv": 8}
OPS_CROSSPOL = 8  # 2 sub, div, 3 mul, add, compare (K2, K4)
OPS_DOT4 = 7  # K6: 4 mul, 3 add per entry, then one min or compare


def log(msg):
    print(msg, flush=True)


def live_pixels(torch, feats, axis=-1):
    """Pixels of a feats tensor that are not padding (not all NaN)."""
    return int((~torch.isnan(feats).all(axis)).sum())


def nbytes(torch, *tensors):
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def bound(fp32_ops, n_bytes, bf16_ops=0):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops = max(fp32_ops / PEAK_FP32, bf16_ops / PEAK_BF16)
    t_bytes = n_bytes / PEAK_BYTES
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def kernel_bound(torch, K, name, args, kwargs, out):
    """The bound of inversion kernel ``name`` on the arguments it was given."""
    rows = kwargs.get("n_rows", K.SLAB_ROWS)
    if name in ("group_argmin", "group_argmin_streamed"):
        fp32 = live_pixels(torch, args[4]) * args[1].numel() * OPS_DIRECT
    elif name == "slab_refine_fused":
        per_px = rows * args[0].shape[2] * OPS_DIRECT
        if kwargs.get("has_cr", True):
            per_px += args[6].numel() * OPS_CROSSPOL
        fp32 = live_pixels(torch, args[7]) * per_px
    elif name == "slab_refine":
        fp32 = live_pixels(torch, args[3]) * rows * args[0].shape[2] * OPS_DIRECT
    else:  # crosspol_argmin
        fp32 = live_pixels(torch, args[2]) * args[1].numel() * OPS_CROSSPOL
    return bound(fp32, nbytes(torch, *args, out))


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
    return getattr(K, f"_{name}_plain")


def entry_of(name, kwargs):
    """The ``kernels`` line's entry for a call of wrapper ``name``: K2 and K3
    on the fused_exact mode's 32-row slab have entries of their own."""
    return f"{name}:32_rows" if kwargs.get("n_rows", 48) == 32 else name


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
    return args[KERNELS[name][2]]


def sweep_note(torch, K, name, args):
    """The work a kernel's sweep is given: live pixels (those whose first
    feature, s0, is not NaN), slots of the blocks it runs (for K2/K3 those
    with vmask 1), and slots it sweeps (32-pixel groups holding a live
    pixel)."""
    s0 = feats_of(name, args)[:, 0]
    if name in ("slab_refine_fused", "slab_refine"):
        s0 = s0.reshape(-1, K.SLAB_BLOCK)
        s0 = s0[args[-1].to(torch.bool)]
    live = ~torch.isnan(s0)
    groups = live.reshape(-1, 32).any(-1)
    return (f"; live px {int(live.sum())}, slots in running blocks {s0.numel()}, "
            f"slots swept {int(groups.sum()) * 32}")


def time_against_plain(torch, K, name, args, kwargs, entry):
    """CUDA-event ms of the kernel (5 calls after a warm-up) and of its
    plain version (1), and the kernel's bound on these arguments."""
    from xsarsea_tpu_torch.scripts import cuda_ms

    entry["ms"] = cuda_ms(lambda: getattr(K, name)(*args, **kwargs), 5)
    entry["plain_ms"] = cuda_ms(
        lambda: plain_version(K, name)(*args, **kwargs, chunk_blocks=128), 1)
    out = getattr(K, name)(*args, **kwargs)
    entry["bound_ms"], entry["bound_by"] = kernel_bound(torch, K, name, args, kwargs, out)


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


def device_inputs(torch, sc, s0_cr_db):
    """``(lo, hi) ->`` the scene's pixels [lo, hi) as float32 CUDA tensors."""
    def inputs(lo, hi):
        f32 = dict(dtype=torch.float32, device="cuda")
        return (torch.as_tensor(sc["inc"][lo:hi], **f32),
                torch.as_tensor(sc["s0_co_db"][lo:hi], **f32),
                torch.as_tensor(s0_cr_db[lo:hi], **f32),
                torch.as_tensor(sc["dsig_cr"][lo:hi], **f32),
                torch.as_tensor(sc["anc"][lo:hi].astype(np.complex64), device="cuda"))
    return inputs


def hold_on_subsample(torch, K, tables, dev_inputs, n_sub, report, phase, mode="fused"):
    """Every kernel of a fused call on the first ``n_sub`` pixels against
    its plain version on the arguments that call gave it."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    with captured_calls(K) as calls:
        invert_pixels(tables, *dev_inputs(0, n_sub), mode=mode, device="cuda")
    for name, (args, kwargs) in calls.items():
        err, size = hold_against_plain(torch, K, name, args, kwargs, phase)
        entry = report[entry_of(name, kwargs)]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        log(f"{phase} {name}: bit-equal to its plain version on {size} outputs "
            f"(feats {tuple(feats_of(name, args).shape)})")
    return calls


def hold_on_seams(torch, K, tables, report, phase, n_rows=None):
    """K2 and K3 against their plain versions on the seam cases of their
    sweep at the LUT's width and height and a slab of ``n_rows`` rows
    (default 48), and at the cases' designed K3 answers."""
    from xsarsea_tpu_torch.ops.slab_seams import seam_cases

    n_rows = n_rows or K.SLAB_ROWS
    cases = seam_cases(n_phi=tables.co_lut.shape[2], n_wspd=tables.co_lut.shape[1],
                       n_rows=n_rows)
    block = {"block": K.SLAB_BLOCK, **({} if n_rows == K.SLAB_ROWS else {"n_rows": n_rows})}
    for name, args, kwargs in (("slab_refine_fused", cases.k2_args("cuda"),
                                {"has_cr": True, **block}),
                               ("slab_refine", cases.k3_args("cuda"), block)):
        err, size = hold_against_plain(torch, K, name, args, kwargs, phase)
        entry = report[entry_of(name, kwargs)]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        line = (f"{phase} {name}: bit-equal to its plain version on the sweep's seam cases "
                f"({size} outputs, {cases.sband.shape[0]} blocks, width {cases.n_phi}, "
                f"{n_rows} slab rows)")
        if name == "slab_refine":
            flat = getattr(K, name)(*args, **kwargs).reshape(-1).cpu().numpy()
            wrong = sum(int(flat[s] != e) for s, e in cases.expected.items())
            if wrong:
                raise SystemExit(f"{phase}: slab_refine misses {wrong} of the seam cases' "
                                 f"{len(cases.expected)} designed answers")
            line += f", and at their {len(cases.expected)} designed answers"
        log(line)


def hold_on_coarse_seams(torch, K, n_cols, crosspol_widths, n_phi, report, phase):
    """K1 on the seam cases of its sweep at ``n_cols`` coarse columns, K4 on
    the crosspol loop's at each of ``crosspol_widths`` and K2 on them at the
    last of these (its slab ``n_phi`` wide): against their plain versions,
    bit for bit, and at the cases' designed answers."""
    from xsarsea_tpu_torch.ops import coarse_seams

    def hold(name, args, kwargs, expected, got_of, what):
        err, size = hold_against_plain(torch, K, name, args, kwargs, phase)
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        got = got_of(getattr(K, name)(*args, **kwargs)).cpu().numpy()
        wrong = sum(int(got[s] != e) for s, e in expected.items())
        if wrong:
            raise SystemExit(f"{phase}: {name} misses {wrong} of the {len(expected)} designed "
                             f"answers of {what}")
        log(f"{phase} {name}: bit-equal to its plain version on {what} ({size} outputs), "
            f"and at their {len(expected)} designed answers")

    cases = coarse_seams.coarse_seam_cases(n_cols)
    hold("group_argmin", cases.args("cuda"), {"block": K.GROUP_BLOCK}, cases.expected,
         lambda out: out.reshape(-1), f"its sweep's seam cases, {n_cols} columns")
    for n_cr in crosspol_widths:
        cases = coarse_seams.crosspol_seam_cases(n_cr)
        hold("crosspol_argmin", cases.args("cuda"), {"block": K.CR_BLOCK}, cases.expected,
             lambda out: out.reshape(-1), f"the crosspol loop's seam cases, {n_cr} entries")
    fused, expected = coarse_seams.fused_crosspol_seam_cases(crosspol_widths[-1], n_phi)
    hold("slab_refine_fused", fused.k2_args("cuda"), {"has_cr": True, "block": K.SLAB_BLOCK},
         expected, lambda out: out.permute(0, 2, 1).reshape(-1, 4)[:, 2],
         f"the crosspol loop's seam cases, {crosspol_widths[-1]} entries")


def hold_quotient(torch, K, luts, random_pairs, phase):
    """The crosspol loop's hoisted quotient against the true divide on the
    card (``a / b``, IEEE), bit for bit and NaN for NaN: ``random_pairs``
    random bit patterns, as many pairs inside the hoisted route's windows,
    and the edge set with the differences of ``luts``."""
    from xsarsea_tpu_torch.ops import coarse_seams

    sets = {"edge": coarse_seams.quotient_edge_set("cuda", luts)}
    if random_pairs:
        sets["random-bit"] = coarse_seams.quotient_random_set(random_pairs, 0, "cuda", False)
        sets["in-window"] = coarse_seams.quotient_random_set(random_pairs, 1, "cuda", True)
    notes = []
    for name, (a, b) in sets.items():
        q, hoisted = K.crosspol_quotient(a, b)
        ref = a / b
        same = (q.view(torch.int32) == ref.view(torch.int32)) | (q.isnan() & ref.isnan())
        n_hoisted = int(hoisted.sum())
        if not bool(same.all()) or n_hoisted == 0:
            raise SystemExit(f"{phase}: the hoisted quotient differs from the true divide on "
                             f"{int((~same).sum())} of {a.numel()} {name} pairs "
                             f"({n_hoisted} hoisted)")
        notes.append(f"{a.numel()} {name} pairs ({n_hoisted} hoisted)")
    log(f"{phase} crosspol quotient: bit-equal to the true divide on {', '.join(notes)}")


def device_rate(torch, K, tables, dev, reps, mode="fused"):
    """Seconds of ``reps`` device-resident fused calls after a warm-up call,
    and the arguments the warm-up gave each kernel."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    def once():
        invert_pixels(tables, *dev, mode=mode, device="cuda", device_output=True)
        torch.cuda.synchronize()

    with captured_calls(K) as calls:
        once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return times, calls


def fused_vs_exact(torch, tables, sc, dev_inputs, n_sub, phase, mode="fused"):
    """Fused against exact on the card on the first ``n_sub`` pixels: the
    count of differing pixels, the max speed deviation and, for up to 10
    differing pixels, the exact-form cost gap of the fused winner."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    fused = invert_pixels(tables, *dev_inputs(0, n_sub), mode=mode, device="cuda")
    exact = invert_pixels(tables, *dev_inputs(0, n_sub), mode="exact", device="cuda",
                          chunk_size=1024)
    differ = np.zeros(n_sub, bool)
    dev_max = 0.0
    for f, e in zip(fused, exact):
        differ |= ~((f == e) | (np.isnan(f) & np.isnan(e)))
        dev_max = max(dev_max, float(np.nanmax(np.abs(np.abs(f) - np.abs(e)))))
    log(f"{phase} {mode} vs exact on {n_sub} px: {int(differ.sum())} differing pixels, "
        f"cuda_vs_exact_max_dev_m_s {dev_max}")
    idx = np.nonzero(differ)[0][:10]
    gaps, _ = cost_gaps(torch, tables, sc["inc"][idx], sc["s0_co_db"][idx], sc["anc"][idx],
                        fused[0][idx])
    for i, gap in zip(idx, gaps):
        log(f"  pixel {i}: {mode} {fused[0][i]:.6f} exact {exact[0][i]:.6f}, "
            f"exact-form cost gap {gap:.3e}")


def bilinear(x_grid, y_grid, table, x, y):
    """Bilinear interpolation of ``table`` (len(x_grid), len(y_grid)) at the
    points (x, y), float64, clamped to the grid."""
    def weights(grid, v):
        i = np.clip(np.searchsorted(grid, v), 1, len(grid) - 1)
        w = np.clip((v - grid[i - 1]) / (grid[i] - grid[i - 1]), 0.0, 1.0)
        return i, w

    ix, wx = weights(x_grid, x)
    iy, wy = weights(y_grid, y)
    return (table[ix - 1, iy - 1] * (1 - wx) * (1 - wy) + table[ix, iy - 1] * wx * (1 - wy)
            + table[ix - 1, iy] * (1 - wx) * wy + table[ix, iy] * wx * wy)


def unfused_pair(sc, tmp):
    """The unfused tail's LUT pair, registered from the repository's fixtures
    (KNMI CMOD7 gunzipped into ``tmp``, the sarwing crosspol LUT), its
    high-res tables, and the scene's crosspol sigma0 (linear, dB) taken from
    the crosspol LUT itself (a closed form, not a published GMF), bilinear
    in float64 at (inc, clip(wspd, 3, 80))."""
    from xsarsea_tpu_torch.models import get_model, register_cmod7, register_pickle_luts
    from xsarsea_tpu_torch.windspeed.inversion import prepare_tables

    (tmp / "cmod7").mkdir()
    with gzip.open(DATA / "knmi_cmod7" / "cmod7" / "gmf_cmod7_vv.dat_little_endian.gz",
                   "rb") as f_in, \
            open(tmp / "cmod7" / "gmf_cmod7_vv.dat_little_endian", "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    register_cmod7(str(tmp / "cmod7"))
    register_pickle_luts(str(DATA / "sarwing_luts" / "GMF_fix_cr_2_1"))
    tables = prepare_tables(*UNFUSED_MODELS)
    lut_cr = get_model(UNFUSED_MODELS[1]).to_lut(units="dB")
    s0_cr_db = bilinear(np.asarray(lut_cr.coords["incidence"], np.float64),
                        np.asarray(lut_cr.coords["wspd"], np.float64),
                        np.asarray(lut_cr.values, np.float64), sc["inc"],
                        np.clip(sc["wspd"], 3.0, 80.0))
    s0_cr = 10.0 ** (s0_cr_db / 10.0)
    return tables, s0_cr, 10 * np.log10(s0_cr + 1e-15)


def phase7(torch, K, sc, n, n_sub, n_rms, reps, report, tmp):
    """The unfused tail: CMOD7 (KNMI fixture) with the sarwing crosspol LUT."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_from_model, invert_pixels

    t0 = time.perf_counter()
    models = UNFUSED_MODELS
    tables, s0_cr, s0_cr_db = unfused_pair(sc, tmp)
    if np.array_equal(tables.co_inc, tables.cr_inc) or tables.co_lut.shape != (501, 499, 181):
        raise SystemExit(f"phase 7: tables {tables.co_lut.shape} + {tables.cr_lut.shape} are "
                         "not the unfused tail's high-res CMOD7 + crosspol pair")
    log(f"phase 7 tables {tables.co_lut.shape} (incidence {tables.co_inc[0]}-"
        f"{tables.co_inc[-1]} deg) + {tables.cr_lut.shape} (incidence {tables.cr_inc[0]}-"
        f"{tables.cr_inc[-1]} deg) and crosspol sigma0 in {time.perf_counter() - t0:.1f} s")

    dev_inputs = device_inputs(torch, sc, s0_cr_db)

    # the main path through the unfused tail, with launch counts
    K.reset_launch_counts()
    t0 = time.perf_counter()
    wind_co, wind_dual = invert_from_model(
        sc["inc"], sc["s0_co"], s0_cr, ancillary_wind=sc["anc"], dsig_co=0.1, dsig_cr=0.1,
        model=models, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    for name in ("group_argmin", "slab_refine", "crosspol_argmin"):
        if launches[name] == 0:
            raise SystemExit(f"phase 7: kernel {name} was not launched by the unfused tail")
    if launches["slab_refine_fused"]:
        raise SystemExit("phase 7: the unfused tail launched slab_refine_fused")
    report["group_argmin"]["launches"] += launches["group_argmin"]
    for name in ("slab_refine", "crosspol_argmin"):
        report[name]["launches"] = launches[name]
    for name, w in (("wind_co", wind_co), ("wind_dual", wind_dual)):
        if w.shape != (n,) or not np.isfinite(w).all():
            raise SystemExit(f"phase 7: {name} has shape {w.shape} or non-finite values")
    co, dual = invert_pixels(tables, sc["inc"][:n_rms], sc["s0_co_db"][:n_rms],
                             s0_cr_db[:n_rms], sc["dsig_cr"][:n_rms], sc["anc"][:n_rms],
                             mode="fused", device="cuda")
    truth = sc["wspd"][:n_rms]
    rms_co = float(np.sqrt(np.nanmean((np.abs(co) - truth) ** 2)))
    rms = float(np.sqrt(np.nanmean((np.abs(dual) - truth) ** 2)))
    log(f"phase 7 invert_from_model {models}: {n} px in {seconds:.2f} s (host in/out, tables "
        f"cached), launches {launches}, rms_vs_truth_m_s copol {rms_co:.6f}, dual-pol "
        f"{rms:.6f} (not gated: the crosspol fixture is a closed form)")

    # device-resident rate, K3/K4 against their plain versions on a subsample
    # and on one 2**22-pixel piece's arguments, with their times
    hold_on_subsample(torch, K, tables, dev_inputs, n_sub, report, "phase 7")
    hold_quotient(torch, K, [tables.cr_lut], 0, "phase 7")
    times, calls = device_rate(torch, K, tables, dev_inputs(0, n), reps)
    log(f"phase 7 invert_pixels device-resident f32, unfused tail: "
        f"{n / statistics.median(times) / 1e6:.3f} Mpx/s (median of {reps}: "
        f"{[round(t, 4) for t in times]} s for {n} px)")
    for name in ("slab_refine", "crosspol_argmin", "group_argmin"):
        args, kwargs = calls[name]
        err, size = hold_against_plain(torch, K, name, args, kwargs, "phase 7")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        timed = dict(report[name]) if name == "group_argmin" else report[name]
        time_against_plain(torch, K, name, args, kwargs, timed)
        log(f"phase 7 {name}: bit-equal to its plain version on {size} outputs at the unfused "
            f"tail's shapes (feats {tuple(feats_of(name, args).shape)}); kernel "
            f"{timed['ms']:.3f} ms, plain {timed['plain_ms']:.3f} ms per call, bound "
            f"{timed['bound_ms']:.3f} ms ({timed['bound_by']})"
            f"{sweep_note(torch, K, name, args)}")

    fused_vs_exact(torch, tables, sc, dev_inputs, n_sub, "phase 7")
    return tables, s0_cr_db


def timed_once(torch, fn):
    """(CUDA-event ms, result) of one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def experiment_entry(torch, family, name, got, ref, ms, plain_ms, launches, bound_ms_by,
                     phase):
    """One K5 form's or K6 variant's line: exit unless it was launched by
    its driver and is bit-equal to its plain version."""
    if launches == 0:
        raise SystemExit(f"{phase}: {name} was not launched by its driver")
    if got.shape != ref.shape or not torch.equal(got, ref):
        bad = int((got != ref).sum()) if got.shape == ref.shape else "all"
        raise SystemExit(f"{phase}: {name} differs from its plain version on {bad} of "
                         f"{ref.numel()} outputs")
    source, replaces = EXPERIMENTS[family]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": float((got.double() - ref.double()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": None}


def phase8(torch, K, report):
    """The experiment drivers: K5's cost forms and K6's variants at 2**23 px."""
    from xsarsea_tpu_torch.ops import experiment_kernels as E
    from xsarsea_tpu_torch.scripts import bench_kernel_variants, bench_slab_forms, cuda_ms

    # K5: the driver's run is the path, with launch counts
    E.reset_launch_counts()
    res = bench_slab_forms.main()
    torch.cuda.synchronize()
    launches = E.launch_counts()
    for form, r in res["forms"].items():
        args = r["args"]
        plain_ms, ref = timed_once(torch, lambda: E._slab_forms_plain(*args, chunk_blocks=128))
        name = f"slab_forms:{form}"
        px = live_pixels(torch, args[5])
        cost_bound = bound(px * K.SLAB_ROWS * args[1].shape[2] * OPS_FORM[form],
                           nbytes(torch, *args[1:], r["out"]))
        report[name] = experiment_entry(torch, "slab_forms", name, r["out"], ref, r["ms"],
                                        plain_ms, launches.get(f"slab_forms/{form}", 0),
                                        cost_bound, "phase 8")
        line = (f"phase 8 {name}: bit-equal to its plain version on {ref.numel()} outputs "
                f"({px} px); kernel {r['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{cost_bound[0]:.4g} ms ({cost_bound[1]})")
        if form == "direct":  # the pre-redesign loop against K3's sweep, same arguments
            k3_args = (*args[1:4], *args[5:])
            k3 = K.slab_refine(*k3_args)
            torch.cuda.synchronize()
            if not torch.equal(k3, r["out"]):
                raise SystemExit("phase 8: the direct form differs from slab_refine (K3)")
            k3_ms = cuda_ms(lambda: K.slab_refine(*k3_args), bench_slab_forms.REPS)
            line += (f"; bit-equal to slab_refine (K3), which takes {k3_ms:.3f} ms on the "
                     f"same arguments (direct / K3 = {r['ms'] / k3_ms:.3f})")
        log(line)
    log(f"phase 8 slab-form flips: {json.dumps(res['flips'])}")

    # K6: the nine variants at 2**23 px
    E.reset_launch_counts()
    results = bench_kernel_variants.main()
    torch.cuda.synchronize()
    launches = E.launch_counts()
    for r in results:
        _, feats, band = r["args"]
        kw = r["kwargs"]
        plain_ms, ref = timed_once(torch, lambda: E._group_argmin_variant_plain(
            *r["args"], kw["block"], kw["reduction"], kw["precision"], chunk_px=16384))
        name = E.variant_name(**kw)
        px = live_pixels(torch, feats, 1)
        reads = 8 if kw["reduction"] == "none" else E.G4_TILE  # entries read per tile
        entries = E.G4_TILES * reads
        product = px * entries * OPS_DOT4
        g4_bytes = int(torch.unique(band).numel()) * E.G4_TILES * 4 * reads * 4
        variant_bound = bound(px * entries + (product if kw["precision"] == "highest" else 0),
                              g4_bytes + nbytes(torch, feats, band, r["out"]),
                              product if kw["precision"] == "default" else 0)
        report[f"group_argmin_variant:{name}"] = experiment_entry(
            torch, "group_argmin_variant", f"group_argmin_variant:{name}", r["out"], ref,
            r["ms"], plain_ms, launches.get(f"group_argmin_variant/{name}", 0), variant_bound,
            "phase 8")
        log(f"phase 8 {r['label']}: bit-equal to its plain version on {ref.numel()} px; "
            f"kernel {r['ms']:.3f} ms ({r['mpx_s']:.1f} Mpx/s), plain {plain_ms:.3f} ms, "
            f"bound {variant_bound[0]:.4g} ms ({variant_bound[1]})")


@contextlib.contextmanager
def serial_piece_loop():
    """Run ``invert_from_model``'s piece loop one piece after the other on the
    calling thread, as the overlapped loop's reference."""
    from xsarsea_tpu_torch.windspeed import inversion as inv

    overlapped = inv._invert_source
    inv._invert_source = functools.partial(overlapped, _overlap=False)
    try:
        yield
    finally:
        inv._invert_source = overlapped


def same_bits(a, b):
    """True when two arrays hold the same bytes (NaN payloads included)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def host_seconds(torch, fn):
    """(result, seconds) of ``fn()``, host clock around synchronized work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hold_against_serial_loop(torch, invert, winds, values_of, phase):
    """Run ``invert()`` through the serial piece loop; exit unless ``winds``,
    the overlapped loop's result, equals it bit for bit. Returns the serial
    loop's seconds."""
    with serial_piece_loop():
        ref, seconds = host_seconds(torch, invert)
    for name, got, want in zip(("wind_co", "wind_dual"), winds, ref):
        if not same_bits(values_of(got), values_of(want)):
            raise SystemExit(f"{phase}: {name} of the overlapped piece loop differs from the "
                             "serial loop's")
    return seconds


# ------------------------------------------------- phase 9: scene preparation

PREP_MODELS = ("gmf_cmod5n", "gmf_s1_v2")
PREP_LAND = (slice(500, 600), slice(700, 900))  # NaN copol sigma0: a land patch
# card against device="cpu" in float64: the line fit sums in another order;
# the others are elementwise (the GMF's exp, pow and tanh differ in the last bits)
PREP_RTOL = {"nesz_flattening": 1e-9, "get_dsig": 1e-12, "sigma0_detrend": 1e-11}
PREP_RTOL_F32 = 1e-3  # the float32 line fit against float64 (cancellation in its denominator)


class LabelledArray:
    """A minimal stand-in for ``xarray.DataArray`` (dims, coords, attrs, name,
    ``values``, ``data``; the constructor's contract), for driving the xarray
    bridge where xarray is not installed."""

    def __init__(self, data, coords=None, dims=None, name=None, attrs=None):
        self.data = data if hasattr(data, "chunks") else np.asarray(data)
        self.dims = tuple(dims) if dims is not None else \
            tuple(f"dim_{i}" for i in range(self.data.ndim))
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})
        self.name = name

    @property
    def values(self):
        return np.asarray(self.data[0:self.data.shape[0]])

    @property
    def shape(self):
        return tuple(self.data.shape)


class ChunkedRows:
    """A chunked duck array over an in-memory one: first-axis slicing only,
    the largest single request recorded."""

    def __init__(self, arr):
        self._arr = arr
        self.shape, self.ndim, self.dtype = arr.shape, arr.ndim, arr.dtype
        self.chunks = ((1,) * arr.shape[0],) + tuple((s,) for s in arr.shape[1:])
        self.max_request = 0

    def __getitem__(self, idx):
        if not isinstance(idx, slice) or idx.step not in (None, 1):
            raise IndexError("first-axis slicing only")
        block = self._arr[idx]
        self.max_request = max(self.max_request, block.size)
        return block


def prep_scene(torch, get_model, ny, nx, seed):
    """A labelled dual-pol scene as an OWI file holds one, as DimArrays over
    host float64 arrays, and its true wind speed. sigma0 is forward-modelled
    from the true wind on the card with 3% multiplicative noise."""
    from xsarsea_tpu_torch import DimArray, dir_meteo_to_sample

    rng = np.random.default_rng(seed)
    inc = np.repeat(np.linspace(18.0, 47.0, nx)[None, :], ny, axis=0)
    speed = rng.uniform(3.0, 22.0, (ny, nx))
    # over land only the crosspol solves, and the dual-pol merge takes the
    # (NaN) copol wind wherever a speed is under 5 m/s: keep the patch above it
    speed[PREP_LAND] = rng.uniform(8.0, 22.0, speed[PREP_LAND].shape)
    wdir = rng.uniform(0.0, 360.0, (ny, nx))  # meteorological convention
    heading = np.full((ny, nx), 347.0)
    phi = np.abs(np.rad2deg(dir_meteo_to_sample(wdir, heading)))
    dev = [torch.as_tensor(a, device="cuda") for a in (inc, speed, phi)]
    nrcs = get_model(PREP_MODELS[0])(*dev, broadcast=True).cpu().numpy()
    nrcs_cr = get_model(PREP_MODELS[1])(dev[0], dev[1], broadcast=True).cpu().numpy()
    nrcs *= rng.uniform(0.97, 1.03, nrcs.shape)
    nrcs_cr *= rng.uniform(0.97, 1.03, nrcs.shape)
    nrcs[PREP_LAND] = np.nan
    nesz_cr = 10.0 ** ((-31.0 + 0.12 * (inc - 30.0) + rng.normal(0, 0.15, inc.shape)) / 10.0)
    nesz_cr[rng.integers(0, ny, 64), rng.integers(0, nx, 64)] = np.nan
    fields = dict(inc=inc, nrcs=nrcs, nrcs_cr=nrcs_cr, nesz_cr=nesz_cr, heading=heading,
                  ecmwf_speed=np.clip(speed + rng.normal(0, 1.0, speed.shape), 0.3, None),
                  ecmwf_dir=wdir + rng.normal(0, 10.0, speed.shape))
    coords = {"line": np.arange(ny), "sample": np.arange(nx)}
    return {k: DimArray(v, dims=("line", "sample"), coords=coords, name=k)
            for k, v in fields.items()}, speed


def prepare_scene(torch, ds, seconds):
    """Phase 9, step 1: the ancillary wind in the antenna convention (on the
    card, from DimArrays moved there), flattened NESZ, ``dsig_cr`` and
    detrended sigma0, each with ``device="cuda"`` on DimArrays over host
    arrays. Adds each step's seconds to ``seconds``."""
    from xsarsea_tpu_torch import dir_meteo_to_sample, sigma0_detrend
    from xsarsea_tpu_torch.windspeed import get_dsig, nesz_flattening

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def ancillary():
        direction = dir_meteo_to_sample(ds["ecmwf_dir"].to("cuda"), ds["heading"].to("cuda"))
        wind = torch.polar(ds["ecmwf_speed"].to("cuda").data, direction.data)
        return direction.copy(data=wind).numpy()

    anc = timed("dir_meteo_to_sample + polar", ancillary)
    nesz_flat = timed("nesz_flattening", lambda: nesz_flattening(ds["nesz_cr"], ds["inc"],
                                                                device="cuda"))
    dsig_cr = timed("get_dsig", lambda: get_dsig(PREP_MODELS[1], ds["inc"], ds["nrcs_cr"],
                                                 nesz_flat, device="cuda"))
    detrended = timed("sigma0_detrend", lambda: sigma0_detrend(
        ds["nrcs"], ds["inc"], model=PREP_MODELS[0], device="cuda"))
    return dict(anc=anc, nesz_flat=nesz_flat, dsig_cr=dsig_cr, detrended=detrended)


def invert_labelled(ds, prep):
    """Phase 9, step 2: dual-pol ``invert_from_model`` on DataArray-like
    inputs, the per-pixel ``dsig_cr`` array among them."""
    from xsarsea_tpu_torch.windspeed import invert_from_model

    def labelled(arr):
        return LabelledArray(arr.data, coords=arr.coords, dims=arr.dims, name=arr.name,
                             attrs=arr.attrs)

    return invert_from_model(
        labelled(ds["inc"]), labelled(ds["nrcs"]), labelled(ds["nrcs_cr"]),
        ancillary_wind=labelled(prep["anc"]), dsig_cr=labelled(prep["dsig_cr"]),
        model=PREP_MODELS, device="cuda")


def max_rel_dev(got, ref):
    """Largest relative deviation of ``got`` from ``ref``; NaN masks must agree."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.array_equal(np.isnan(got), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(got[ok] - ref[ok]) / np.abs(ref[ok])))


def phase9(torch, K, report, card, seed, ny=2048, nx=4096, strip=256):
    """Scene preparation around the inversion, at full width."""
    from xsarsea_tpu_torch import DimArray, sigma0_detrend
    from xsarsea_tpu_torch.models import get_model
    from xsarsea_tpu_torch.windspeed import get_dsig, nesz_flattening

    t0 = time.perf_counter()
    ds, truth = prep_scene(torch, get_model, ny, nx, seed)
    n = ny * nx
    log(f"phase 9 scene: {ny} x {nx} px ({n} px), seed {seed}, in "
        f"{time.perf_counter() - t0:.2f} s")

    # steps 1-2: the path, with launch counts around the inversion
    first, seconds = {}, {}
    prepare_scene(torch, ds, first)  # the process's first calls: allocator and GMF warm-up
    prep = prepare_scene(torch, ds, seconds)
    K.reset_launch_counts()
    with captured_calls(K) as calls:
        (wind_co, wind_dual), seconds["invert_from_model"] = host_seconds(
            torch, lambda: invert_labelled(ds, prep))
    launches = K.launch_counts()
    serial = hold_against_serial_loop(torch, lambda: invert_labelled(ds, prep),
                                      (wind_co, wind_dual), lambda w: w.values, "phase 9")
    log(f"phase 9 invert_from_model: overlapped piece loop {seconds['invert_from_model']:.4f} s, "
        f"serial piece loop {serial:.4f} s, results bit-equal")
    for name in ("group_argmin", "slab_refine_fused"):
        if launches[name] == 0 or name not in calls:
            raise SystemExit(f"phase 9: kernel {name} was not launched by the inversion")
        report[name]["launches"] += launches[name]
    if launches["slab_refine"] or launches["crosspol_argmin"]:
        raise SystemExit("phase 9: the fused tail launched a kernel of the unfused tail")
    dsig_col = calls["slab_refine_fused"][0][7][:, 5]
    if int(torch.unique(dsig_col[~dsig_col.isnan()]).numel()) < 1000:
        raise SystemExit("phase 9: K2 was not given the per-pixel dsig_cr array")
    for name, w in (("wind_co", wind_co), ("wind_dual", wind_dual)):
        if not isinstance(w, LabelledArray) or w.dims != ("line", "sample") \
                or w.shape != (ny, nx) or not {"model", "comment"} <= set(w.attrs):
            raise SystemExit(f"phase 9: {name} is not a labelled (line, sample) array with "
                             f"model and comment attrs: {type(w).__name__} {w.dims} {w.attrs}")
    co_speed, dual_speed = np.abs(wind_co.values), np.abs(wind_dual.values)
    if not np.isnan(co_speed[PREP_LAND]).all() or not np.isfinite(dual_speed[PREP_LAND]).all():
        raise SystemExit("phase 9: land pixels must be NaN in copol and finite in dual-pol wind")
    sea = np.ones((ny, nx), bool)
    sea[PREP_LAND] = False
    if not np.isfinite(co_speed[sea]).all() or not np.isfinite(dual_speed).all():
        raise SystemExit("phase 9: non-finite wind over sea")
    rms = float(np.sqrt(np.mean((dual_speed - truth) ** 2)))
    rms_co = float(np.sqrt(np.mean((co_speed[sea] - truth[sea]) ** 2)))
    log(f"phase 9 invert_from_model through the xarray bridge, per-pixel dsig_cr (median "
        f"{float(np.median(prep['dsig_cr'].values)):.4f}): launches {launches}, "
        f"rms_vs_truth_m_s dual-pol {rms:.6f} (bound 1.0), copol over sea {rms_co:.6f}; "
        f"attrs model '{wind_dual.attrs['model']}'")
    if not rms < 1.0:
        raise SystemExit(f"phase 9: dual-pol speed RMS {rms} m/s against the true wind, "
                         "bound 1.0")
    if prep["detrended"].attrs.get("comment") != f"detrended with model {PREP_MODELS[0]}" \
            or not np.isnan(prep["detrended"].values[PREP_LAND]).all() \
            or not np.isfinite(prep["detrended"].values[sea]).all() \
            or not np.isfinite(prep["nesz_flat"].values).all():
        raise SystemExit("phase 9: detrended sigma0 or flattened NESZ has wrong NaNs or attrs")

    # step 3: card against device="cpu" in float64 on a strip; the float32 line
    # fit; a chunked sigma0
    top = {k: v.isel(line=slice(0, strip)) for k, v in ds.items()}
    flat = prep["nesz_flat"].isel(line=slice(0, strip))
    checks = {
        "nesz_flattening": lambda d: nesz_flattening(top["nesz_cr"], top["inc"], device=d),
        "get_dsig": lambda d: get_dsig(PREP_MODELS[1], top["inc"], top["nrcs_cr"], flat,
                                       device=d),
        "sigma0_detrend": lambda d: sigma0_detrend(top["nrcs"], top["inc"],
                                                   model=PREP_MODELS[0], device=d),
    }
    for name, fn in checks.items():
        dev = max_rel_dev(fn("cuda").values, fn("cpu").values)
        log(f"phase 9 {name}: card vs device='cpu', float64, {strip} x {nx} px: max relative "
            f"deviation {dev:.3e} (tolerance {PREP_RTOL[name]:.0e})")
        if not dev <= PREP_RTOL[name]:
            raise SystemExit(f"phase 9: {name} on the card deviates {dev} from the CPU")
    f32 = nesz_flattening(top["nesz_cr"].astype(np.float32), top["inc"].astype(np.float32),
                          device="cuda")
    dev32 = max_rel_dev(f32.values, flat.values)
    log(f"phase 9 nesz_flattening in float32 on the card vs float64: max relative deviation "
        f"{dev32:.3e} (tolerance {PREP_RTOL_F32:.0e}; the input's dtype is kept, "
        f"{f32.values.dtype} out)")
    if f32.values.dtype != np.float32 or not dev32 <= PREP_RTOL_F32:
        raise SystemExit(f"phase 9: float32 nesz_flattening deviates {dev32} from float64")
    lazy = ChunkedRows(ds["nrcs"].data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunked = sigma0_detrend(DimArray(lazy, dims=("line", "sample")), ChunkedRows(ds["inc"].data),
                             model=PREP_MODELS[0], device="cuda")
    torch.cuda.synchronize()
    seconds["sigma0_detrend, chunked"] = time.perf_counter() - t0
    same = np.array_equal(chunked.values, prep["detrended"].values, equal_nan=True)
    log(f"phase 9 sigma0_detrend on a chunked sigma0: bit-equal to the eager result: {same}; "
        f"largest single request {lazy.max_request} elements")
    if not same or lazy.max_request > 1 << 22:
        raise SystemExit("phase 9: chunked sigma0_detrend differs from eager, or read more than "
                         "one row block at once")

    # step 4: the seconds of each step, with the card beside them
    for name, sec in seconds.items():
        log(f"phase 9 {name}: {sec:.4f} s"
            + (f" (the process's first call: {first[name]:.4f} s)" if name in first else ""))
    path = sum(sec for name, sec in seconds.items() if "chunked" not in name)
    log("phase 9 card (nvidia-smi name, power.limit):")
    log(card)
    log(f"phase 9 rates, host arrays in and out, {n} px: sigma0_detrend "
        f"{n / seconds['sigma0_detrend'] / 1e6:.3f} Mpx/s, whole path (steps 1-2) "
        f"{n / path / 1e6:.3f} Mpx/s in {path:.4f} s")


# ----------------------------------------------------- phase 10: the streaks

STREAK_SLOPE = 0.6  # the tile's streaks: sin(0.35 (x + 0.6 y)), gradient along (1, 0.6)
STREAKS_RTOL_LG = 1e-11  # card vs device="cpu", float64: stencils are sums in a fixed order
STREAKS_RTOL_HIST, STREAKS_ATOL_HIST = 1e-9, 1e-12  # the histogram's sum is in any order
STREAKS_ATOL_F32 = 1e-3  # float32 weight against float64 (a pixel may change bin)
STREAKS_RTOL_TF32 = 1e-5  # float32 stencils and resamplings against float64
STREAKS_RTOL_PATHS = 1e-4  # float32, two paths to one histogram: of the largest weight


def synthetic_tile(ny, nx, seed):
    """The streak scene of the JAX package's benchmark (``_synthetic_tile``):
    a 256-px tile of ``sin(0.35 (x + 0.6 y))`` under N(0, 0.1) noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256]
    tile = 1.0 + 0.5 * np.sin(0.35 * (x + STREAK_SLOPE * y))
    return np.abs(np.tile(tile, (ny // 256, nx // 256))
                  + 0.1 * rng.normal(size=(ny, nx))).astype(np.float32) + 0.01


class GeneratedRows:
    """A scene that exists only as a row generator: a chunked duck array
    (first-axis slicing) whose rows are the streak tile under uniform noise of
    standard deviation 0.1 (cheaper to draw than the tile's normal noise: the
    generator stands for a file's reader, not for the work under test) drawn
    per 256-row stripe from ``(seed, stripe)``, so any range of rows is made
    anew from nothing. Records the largest single request and the seconds
    spent generating."""

    STRIPE = 256

    def __init__(self, ny, nx, seed):
        self.shape, self.ndim, self.dtype = (ny, nx), 2, np.dtype(np.float32)
        self.chunks = ((self.STRIPE,) * (ny // self.STRIPE), (nx,))
        self.seed = seed
        y, x = np.mgrid[0:self.STRIPE, 0:256]
        self._tile = np.tile((1.0 + 0.5 * np.sin(0.35 * (x + STREAK_SLOPE * y)))
                             .astype(np.float32), (1, nx // 256))
        self.max_request = 0
        self.seconds = 0.0

    def _stripe(self, k):
        noise = np.random.default_rng([self.seed, k]).random(self._tile.shape, dtype=np.float32)
        noise -= np.float32(0.5)
        noise *= np.float32(0.1 * 12 ** 0.5)
        noise += self._tile
        return np.abs(noise, out=noise) + np.float32(0.01)

    def __getitem__(self, idx):
        if not isinstance(idx, slice) or idx.step not in (None, 1):
            raise IndexError("first-axis slicing only")
        t0 = time.perf_counter()
        r0, r1, _ = idx.indices(self.shape[0])
        k0, k1 = r0 // self.STRIPE, -(-r1 // self.STRIPE)
        rows = np.concatenate([self._stripe(k) for k in range(k0, k1)])
        block = rows[r0 - k0 * self.STRIPE:r1 - k0 * self.STRIPE]
        self.max_request = max(self.max_request, block.size)
        self.seconds += time.perf_counter() - t0
        return block


def max_dev(got, ref):
    """Largest deviation of ``got`` from ``ref`` over the largest |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.array_equal(np.isnan(got), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(got[ok] - ref[ok])) / np.max(np.abs(ref[ok])))


def streak_peak(weight, n_angles=72):
    """(peak bin's angle, the streaks' gradient direction, bins apart) of the
    mean histogram over all windows. The local gradient's angle is
    ``atan2(d/dline, d/dsample)`` folded into [-pi/2, pi/2)."""
    bins = np.linspace(-np.pi / 2, np.pi / 2, n_angles + 1)
    centers = (bins[1:] + bins[:-1]) / 2
    mean = np.asarray(weight, np.float64).reshape(-1, n_angles).mean(axis=0)
    expected = np.arctan2(STREAK_SLOPE, 1.0)
    peak = centers[int(mean.argmax())]
    return peak, expected, abs(peak - expected) / (np.pi / n_angles)


def phase10(torch, card, seed, tile=4096, class_side=2048, scene=(8192, 16384), strip=4096,
            crop=512, max_block_px=1 << 25):
    """The wind-streak path: the core, the multiscale class, the out-of-core
    scene, and the gates."""
    from xsarsea_tpu_torch import DimArray
    from xsarsea_tpu_torch import gradients as G
    from xsarsea_tpu_torch.ops import conv2d as C
    from xsarsea_tpu_torch.utils import staging

    def rate(fn, px, reps=3):
        fn()
        times = [host_seconds(torch, fn)[1] for _ in range(reps)]
        return px / statistics.median(times) / 1e6, times

    # the single-scale core on the benchmark's tile, device-resident
    win = 40
    n_lg = tile // 4
    centers = np.arange(win // 2, n_lg - win // 2, win, dtype=np.int32)
    bins32 = G._angle_bin_centers(72).astype(np.float32)
    img = synthetic_tile(tile, tile, seed + 1)
    img_d = torch.as_tensor(img, device="cuda")
    cl_d, bins_d = torch.as_tensor(centers, device="cuda"), torch.as_tensor(bins32, device="cuda")
    core_rate, times = rate(lambda: G.streaks_histogram_core(img_d, cl_d, cl_d, win, bins_d),
                            img.size)
    weight, used = (t.cpu().numpy() for t in
                    G.streaks_histogram_core(img_d, cl_d, cl_d, win, bins_d))
    peak, expected, bins_off = streak_peak(weight)
    log(f"phase 10 streaks_histogram_core, device-resident f32, {tile} x {tile} px, "
        f"{len(centers) ** 2} windows of {win} x {win} lg px: {core_rate:.3f} Mpx/s (median of "
        f"{len(times)}: {[round(t, 4) for t in times]} s); peak of the mean histogram at "
        f"{np.rad2deg(peak):.2f} deg, streaks' gradient at {np.rad2deg(expected):.2f} deg "
        f"({bins_off:.2f} bins apart)")
    if weight.shape != (len(centers) ** 2, 72) or not np.isfinite(weight).all() \
            or not (used == 1.0).all() or not bins_off <= 1.0:
        raise SystemExit(f"phase 10: the core's histogram has shape {weight.shape}, non-finite "
                         f"weights, interior windows with used_ratio != 1 "
                         f"(min {used.min()}), or its peak {bins_off:.2f} bins off the streaks")

    # the multiscale class, construction included; fused against per-instance
    side = class_side
    base = synthetic_tile(side, side, seed + 2)
    stack_d = torch.as_tensor(np.stack([base, 0.2 * base]), device="cuda")
    da = DimArray(stack_d, dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]), "line": np.arange(side) * 10.0,
                          "sample": np.arange(side) * 10.0})
    kw = dict(windows_sizes=[1600, 3200], downscales_factors=[1, 2])
    class_rate, times = rate(lambda: G.Gradients(da, **kw).histogram, stack_d.numel())
    fused = G.Gradients(da, **kw).histogram
    per_instance = G.Gradients(da, **kw)
    per_instance.gradients_list  # touching the instances takes the per-instance path
    inst = per_instance.histogram
    dev_paths = max_dev(inst["weight"].values, fused["weight"].values)
    dims = ("pol", "downscale_factor", "window_size", "line", "sample", "angles")
    log(f"phase 10 Gradients(windows_sizes=[1600, 3200], downscales_factors=[1, 2]).histogram, "
        f"device-resident f32, 2 x {side} x {side} px at 10 m, construction included: "
        f"{class_rate:.3f} Mpx/s (median of {len(times)}: {[round(t, 4) for t in times]} s); "
        f"weight {tuple(fused['weight'].shape)}; fused vs per-instance: {dev_paths:.3e} of the "
        f"largest weight (tolerance {STREAKS_RTOL_PATHS:.0e}: float32 sums in any order)")
    if fused["weight"].dims != dims or inst["weight"].dims != dims \
            or not np.isfinite(fused["weight"].values).all() \
            or not dev_paths <= STREAKS_RTOL_PATHS \
            or not np.array_equal(fused["used_ratio"].values, inst["used_ratio"].values):
        raise SystemExit("phase 10: the multiscale histogram has wrong dims or non-finite "
                         f"weights, or its two paths differ ({dev_paths})")

    # a product-size scene through the out-of-core path
    ny, nx = scene
    coords = {"line": np.arange(ny) * 10.0, "sample": np.arange(nx) * 10.0}
    rows = GeneratedRows(ny, nx, seed)
    pinned0 = staging.pool().bytes

    def out_of_core():
        return G.Gradients2D(DimArray(rows, dims=("line", "sample"), coords=coords),
                             window_size=1600, device="cuda").histogram["weight"].values

    big, seconds = host_seconds(torch, out_of_core)
    peak, expected, bins_off = streak_peak(big)
    log(f"phase 10 Gradients2D on a generated {ny} x {nx} px scene ({ny * nx} px, "
        f"{ny * nx * 4 / 1e6:.0f} MB as float32, never whole in host memory), window 1,600 m, "
        f"{big.shape[0]} x {big.shape[1]} windows: {seconds:.3f} s = "
        f"{ny * nx / seconds / 1e6:.3f} Mpx/s, of which the generator {rows.seconds:.3f} s "
        f"({ny * nx / (seconds - rows.seconds) / 1e6:.3f} Mpx/s without it); "
        f"largest single request {rows.max_request} px (bound {1 << 25}); pinned staging "
        f"{staging.pool().bytes / 1e6:.0f} MB ({pinned0 / 1e6:.0f} MB before); peak "
        f"{bins_off:.2f} bins off the streaks")
    if not np.isfinite(big).all() or not 0 < rows.max_request <= 1 << 25 \
            or not bins_off <= 1.0:
        raise SystemExit("phase 10: the out-of-core histogram is not finite, a band asked for "
                         f"{rows.max_request} px, or the peak is {bins_off:.2f} bins off")
    top = {"line": coords["line"][:strip], "sample": coords["sample"]}
    lazy_strip = GeneratedRows(strip, nx, seed)
    in_memory = GeneratedRows(strip, nx, seed)[0:strip]
    eager = G.Gradients2D(DimArray(in_memory, dims=("line", "sample"), coords=top),
                          window_size=1600, device="cuda").histogram
    win_lg, cl, cs = G._lg_window_spec(top, 1600, eager["weight"].coords)
    banded = [t.cpu().numpy().reshape(len(cl), len(cs), -1) for t in G._banded_streaks_hist(
        lazy_strip, cl, cs, win_lg, G._angle_bin_centers(72), max_block_px=max_block_px,
        device="cuda")]
    dev_strip = max_dev(banded[0], eager["weight"].values)
    n_strip = eager["weight"].shape[0]
    dev_big = max_dev(big[:n_strip - 1], eager["weight"].values[:n_strip - 1])
    log(f"phase 10 out-of-core vs in-memory on the first {strip} x {nx} px: banded strip "
        f"(largest request {lazy_strip.max_request} px) {dev_strip:.3e}, the whole scene's first "
        f"{n_strip - 1} window rows {dev_big:.3e} of the largest weight (tolerance "
        f"{STREAKS_RTOL_PATHS:.0e})")
    if not lazy_strip.max_request < strip * nx or not dev_strip <= STREAKS_RTOL_PATHS \
            or not dev_big <= STREAKS_RTOL_PATHS \
            or not np.array_equal(banded[1][..., 0], eager["used_ratio"].values):
        raise SystemExit("phase 10: the out-of-core path differs from the in-memory one, or "
                         "read the strip whole")

    # the card against device="cpu" in float64 on a crop; float32 against float64
    small = img[:crop, :crop].astype(np.float64)
    cl = np.r_[0, np.arange(win // 2, crop // 4 - win // 2, win // 2), crop // 4 - 1]
    bins = G._angle_bin_centers(72)
    sides = (("card", "cuda"), ("host", "cpu"))
    lg = {side: G.local_gradients(G.Gradients2D(small, device=d).ampl) for side, d in sides}
    for name in ("G2", "G3", "c"):
        got, ref = lg["card"][name].values, lg["host"][name].values
        dev = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        log(f"phase 10 local_gradients {name}: card vs device='cpu', float64, {crop} x {crop} "
            f"px: {dev:.3e} of the largest value (tolerance {STREAKS_RTOL_LG:.0e})")
        if got.shape != ref.shape or not dev <= STREAKS_RTOL_LG:
            raise SystemExit(f"phase 10: local_gradients {name} on the card deviates {dev}")
    hist = {side: [t.cpu().numpy() for t in G.streaks_histogram_core(small, cl, cl, win, bins,
                                                                      device=d)]
            for side, d in sides}
    close = np.isclose(hist["card"][0], hist["host"][0], rtol=STREAKS_RTOL_HIST,
                       atol=STREAKS_ATOL_HIST)
    log(f"phase 10 streaks_histogram_core: card vs device='cpu', float64, {len(cl) ** 2} "
        f"windows (border windows clipped): {int((~close).sum())} of {close.size} bins outside "
        f"rtol {STREAKS_RTOL_HIST:.0e} + atol {STREAKS_ATOL_HIST:.0e}, largest deviation "
        f"{np.abs(hist['card'][0] - hist['host'][0]).max():.3e}")
    if not close.all() or not np.array_equal(hist["card"][1], hist["host"][1]):
        raise SystemExit("phase 10: the histograms on the card deviate from the CPU's")
    w32 = G.streaks_histogram_core(small.astype(np.float32), cl, cl, win, bins32,
                                   device="cuda")[0].cpu().numpy()
    dev32 = float(np.abs(w32 - hist["card"][0]).max())
    log(f"phase 10 streaks_histogram_core in float32 on the card vs float64: largest deviation "
        f"of weight {dev32:.3e} (tolerance {STREAKS_ATOL_F32:.0e}; the largest weight is "
        f"{hist['card'][0].max():.3e})")
    if w32.dtype != np.float32 or not dev32 <= STREAKS_ATOL_F32:
        raise SystemExit(f"phase 10: float32 weight deviates {dev32} from float64")

    # TF32 allowed by the caller must not reach the stencils or the resamplings
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        x64 = torch.as_tensor(img[:1024, :1024].astype(np.float64), device="cuda")
        uneven = np.random.default_rng(seed).normal(size=(4, 5))
        for name, fn in (("resize_area", lambda x: C.resize_area(x, (341, 341))),
                         ("zoom_bilinear", lambda x: C.zoom_bilinear(x, (1500, 1500))),
                         ("conv2d_same, 4 x 5 kernel", lambda x: C.conv2d_same(x, uneven)),
                         ("r2_reduce", C.r2_reduce)):
            dev = max_dev(fn(x64.float()).cpu().numpy(), fn(x64).cpu().numpy())
            log(f"phase 10 {name}: float32 vs float64 on the card, TF32 allowed by the caller: "
                f"{dev:.3e} of the largest value (tolerance {STREAKS_RTOL_TF32:.0e})")
            if not dev <= STREAKS_RTOL_TF32:
                raise SystemExit(f"phase 10: {name} in float32 deviates {dev} from float64")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    log("phase 10 card (nvidia-smi name, power.limit):")
    log(card)


# ------------------------------- phase 11: fused_exact, the margin sweep, parallel/

EXACT_ROWS = 32  # the fused_exact mode's slab (K.EXACT_SLAB_ROWS)
EXACT_ENTRIES = ("group_argmin_streamed", "slab_refine_fused:32_rows", "slab_refine:32_rows")
SWEEP_SMOKE = ((0.8, 4.0, 16), (0.8, 4.0, 8), (1.6, 4.0, 16))  # the default row and two others
BATCH_SHAPES = ((2048, 2560), (1600, 2304), (2560, 1800), (1900, 1700))  # 16,767,280 px


def time_and_hold(torch, K, name, args, kwargs, entry, phase):
    """A kernel on one piece's arguments: its CUDA-event ms (5 calls after a
    warm-up), its plain version's ms (one call, whose output it must equal
    bit for bit) and its bound. Returns the note of the work swept."""
    from xsarsea_tpu_torch.scripts import cuda_ms

    entry["ms"] = cuda_ms(lambda: getattr(K, name)(*args, **kwargs), 5)
    got = getattr(K, name)(*args, **kwargs)
    entry["plain_ms"], ref = timed_once(
        torch, lambda: plain_version(K, name)(*args, **kwargs, chunk_blocks=128))
    if got.shape != ref.shape or not torch.equal(got, ref):
        bad = int((got != ref).sum()) if got.shape == ref.shape else "all"
        raise SystemExit(f"{phase}: {name} differs from its plain version on {bad} of "
                         f"{ref.numel()} outputs of one piece")
    entry["max_abs_err"] = max(entry["max_abs_err"], float((got.double() - ref.double())
                                                           .abs().max()))
    entry["bound_ms"], entry["bound_by"] = kernel_bound(torch, K, name, args, kwargs, got)
    log(f"{phase} {entry['name']}: bit-equal to its plain version on {ref.numel()} outputs of "
        f"one piece (feats {tuple(feats_of(name, args).shape)}); kernel {entry['ms']:.3f} ms, "
        f"plain {entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms "
        f"({entry['bound_by']}){sweep_note(torch, K, name, args)}")


def exact_path_launches(torch, K, tables, dev, expect, phase):
    """The fused_exact mode through ``invert_pixels`` on device-resident
    inputs, with every count set to 0 just before and read just after:
    exits unless exactly the kernels ``expect`` were launched, K2 and K3 on
    32-row slabs. Returns (launches, the arguments each kernel was given)."""
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    K.reset_launch_counts()
    with captured_calls(K) as calls:
        invert_pixels(tables, *dev, mode="fused_exact", device="cuda", device_output=True)
        torch.cuda.synchronize()
    launches = K.launch_counts()
    if {k for k, v in launches.items() if v} != set(expect):
        raise SystemExit(f"{phase}: fused_exact launched {launches}, expected {expect}")
    for name in ("slab_refine_fused", "slab_refine"):
        if name in calls and calls[name][1].get("n_rows") != EXACT_ROWS:
            raise SystemExit(f"{phase}: {name} was not given a {EXACT_ROWS}-row slab")
    return launches, calls


def differing(a, b):
    """Pixels of two complex results that differ (NaN equal to NaN)."""
    return ~((a == b) | (np.isnan(a) & np.isnan(b)))


def batch_scenes(torch, get_model, lut_cr, seed):
    """Phase 11's batch: scenes of ``BATCH_SHAPES`` from ``seed``, incidence
    rising along the samples over 18-47 deg, uniform speed and direction,
    copol sigma0 forward-modelled with ``gmf_cmod5n`` (float64, on the card),
    crosspol sigma0 from the crosspol LUT as in phase 7, a noisy ancillary
    wind, scalar ``dsig_cr``; as ``invert_scenes`` takes them (dB)."""
    rng = np.random.default_rng(seed + 11)
    grids = (np.asarray(lut_cr.coords["incidence"], np.float64),
             np.asarray(lut_cr.coords["wspd"], np.float64), np.asarray(lut_cr.values, np.float64))
    scenes = []
    for ny, nx in BATCH_SHAPES:
        inc = np.repeat(np.linspace(18.0, 47.0, nx)[None, :], ny, 0)
        wspd = rng.uniform(0.5, 45.0, (ny, nx))
        phi = rng.uniform(0.0, 360.0, (ny, nx))
        dev = [torch.as_tensor(a, device="cuda") for a in (inc, wspd, phi)]
        s0_co = get_model("gmf_cmod5n")(*dev, broadcast=True).cpu().numpy()
        s0_cr_db = bilinear(*grids, inc, np.clip(wspd, 3.0, 80.0))
        anc = (wspd + rng.normal(0, 1.5, (ny, nx))).clip(0.2) * np.exp(1j * np.deg2rad(phi))
        scenes.append(dict(inc=inc, sigma0_co_db=10 * np.log10(s0_co + 1e-15),
                           sigma0_cr_db=10 * np.log10(10.0 ** (s0_cr_db / 10.0) + 1e-15),
                           dsig_cr=0.1, ancillary_wind=anc))
    return scenes


def phase11(torch, K, sc, tables, own, report, card, seed, n, n_sub, n_cmp, reps):
    """fused_exact on the bench scene and on the own-axes tables, its kernel
    forms against their plain versions; the margin sweep's default row and
    two others; ``invert_scenes`` on one card; a mesh naming the card twice."""
    from xsarsea_tpu_torch import gradients as G
    from xsarsea_tpu_torch import parallel as par
    from xsarsea_tpu_torch.models import get_model
    from xsarsea_tpu_torch.ops import coarse_seams
    from xsarsea_tpu_torch.scripts import sweep_margin
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    own_tables, own_s0_cr_db = own
    for name in EXACT_ENTRIES:
        wrapper = name.split(":")[0]
        report[name] = {"name": name, "route": "cuda", "source": KERNELS[wrapper][0],
                        "replaces": KERNELS[wrapper][1], "launches": 0, "max_abs_err": 0.0,
                        "library_ms": None, **report.get(name, {})}
    dev_inputs = device_inputs(torch, sc, sc["s0_cr_db"])
    own_inputs = device_inputs(torch, sc, own_s0_cr_db)

    # (a) the path: fused_exact on the bench scene, then on the own-axes
    # tables (one 2**22-pixel piece), each with launch counts
    t0 = time.perf_counter()
    launches, calls = exact_path_launches(torch, K, tables, dev_inputs(0, n),
                                          ("group_argmin_streamed", "slab_refine_fused"),
                                          "phase 11")
    report["group_argmin_streamed"]["launches"] = launches["group_argmin_streamed"]
    report["slab_refine_fused:32_rows"]["launches"] = launches["slab_refine_fused"]
    own_launches, own_calls = exact_path_launches(
        torch, K, own_tables, own_inputs(0, 1 << 22),
        ("group_argmin_streamed", "slab_refine", "crosspol_argmin"), "phase 11")
    report["group_argmin_streamed"]["launches"] += own_launches["group_argmin_streamed"]
    report["slab_refine:32_rows"]["launches"] = own_launches["slab_refine"]
    log(f"phase 11 fused_exact launches: {launches} on {n} px (one axis), {own_launches} on "
        f"{1 << 22} px (own axes), in {time.perf_counter() - t0:.1f} s")
    times, _ = device_rate(torch, K, tables, dev_inputs(0, n), reps, mode="fused_exact")
    log(f"phase 11 invert_pixels(mode='fused_exact') device-resident f32: "
        f"{n / statistics.median(times) / 1e6:.3f} Mpx/s (median of {reps}: "
        f"{[round(t, 4) for t in times]} s for {n} px)")

    # the kernel forms against their plain versions: subsamples, seams, pieces
    hold_on_subsample(torch, K, tables, dev_inputs, n_sub, report, "phase 11", "fused_exact")
    hold_on_subsample(torch, K, own_tables, own_inputs, n_sub, report, "phase 11",
                      "fused_exact")
    cases = coarse_seams.coarse_seam_cases(tables.co_lut.shape[2])
    err, size = hold_against_plain(torch, K, "group_argmin_streamed", cases.args("cuda"),
                                   {"block": K.GROUP_BLOCK}, "phase 11")
    got = K.group_argmin_streamed(*cases.args("cuda")).reshape(-1).cpu().numpy()
    wrong = sum(int(got[s] != e) for s, e in cases.expected.items())
    if wrong:
        raise SystemExit(f"phase 11: group_argmin_streamed misses {wrong} of the seam cases' "
                         "designed answers")
    log(f"phase 11 group_argmin_streamed: bit-equal to its plain version on K1's seam cases "
        f"({size} outputs, {tables.co_lut.shape[2]} columns, {cases.n_groups} groups), and at "
        f"their {len(cases.expected)} designed answers")
    hold_on_seams(torch, K, tables, report, "phase 11", n_rows=EXACT_ROWS)
    time_and_hold(torch, K, "group_argmin_streamed", *calls["group_argmin_streamed"],
                  report["group_argmin_streamed"], "phase 11")
    time_and_hold(torch, K, "slab_refine_fused", *calls["slab_refine_fused"],
                  report["slab_refine_fused:32_rows"], "phase 11")
    time_and_hold(torch, K, "slab_refine", *own_calls["slab_refine"],
                  report["slab_refine:32_rows"], "phase 11")

    # fused_exact against exact; fused against fused_exact (the gate)
    fused_vs_exact(torch, tables, sc, dev_inputs, n_sub, "phase 11", mode="fused_exact")
    fe, fu = (invert_pixels(tables, *dev_inputs(0, n_cmp), mode=m, device="cuda")
              for m in ("fused_exact", "fused"))
    diff = differing(fe[0], fu[0]) | differing(fe[1], fu[1])
    log(f"phase 11 fused vs fused_exact on the first {n_cmp} px: {int(diff.sum())} differing "
        f"pixels (gate: 0)")
    if diff.any():
        for i in np.nonzero(diff)[0][:10]:
            log(f"  pixel {i}: fused {fu[0][i]:.6f} / {fu[1][i]:.6f}, fused_exact "
                f"{fe[0][i]:.6f} / {fe[1][i]:.6f}")
        raise SystemExit("phase 11: fused differs from fused_exact on the bench scene")
    done_a = time.perf_counter()
    log(f"phase 11 (a) in {done_a - t0:.1f} s")

    # (b) the margin sweep's default row and two others
    res = sweep_margin.main(n=1 << 22, configs=SWEEP_SMOKE, reps=2,
                            log=lambda line: log(f"phase 11 sweep_margin: {line}"))
    if res["rows"][0]["config"] != sweep_margin.DEFAULT:
        raise SystemExit("phase 11: the sweep's first row is not the default configuration")
    done_b = time.perf_counter()
    log(f"phase 11 (b) in {done_b - done_a:.1f} s")

    # (c) invert_scenes on one card: four scenes of different shapes, no mesh
    lut_cr = get_model(UNFUSED_MODELS[1]).to_lut(units="dB")
    scenes = batch_scenes(torch, get_model, lut_cr, seed)
    n_batch = sum(s["inc"].size for s in scenes)
    K.reset_launch_counts()
    outs, seconds = host_seconds(torch, lambda: par.invert_scenes(own_tables, scenes))
    launches = K.launch_counts()
    if not all(launches[k] for k in ("group_argmin", "slab_refine", "crosspol_argmin")):
        raise SystemExit(f"phase 11: invert_scenes launched {launches}")
    for k, (scene, (co, dual)) in enumerate(zip(scenes, outs)):
        ref = invert_pixels(own_tables, *(scene[f].reshape(-1) for f in (
            "inc", "sigma0_co_db", "sigma0_cr_db")), np.full(scene["inc"].size, 0.1),
            scene["ancillary_wind"].reshape(-1), device="cuda")
        if co.shape != scene["inc"].shape or not same_bits(co.reshape(-1), ref[0]) \
                or not same_bits(dual.reshape(-1), ref[1]):
            raise SystemExit(f"phase 11: invert_scenes differs from invert_pixels on scene {k}")
    log(f"phase 11 invert_scenes, {len(scenes)} scenes {list(BATCH_SHAPES)} ({n_batch} px), "
        f"{UNFUSED_MODELS} high-res, no mesh, host arrays in and out: {seconds:.4f} s = "
        f"{n_batch / seconds / 1e6:.3f} Mpx/s, launches {launches}; each scene bit-equal to "
        f"invert_pixels")
    del scenes, outs
    done_c = time.perf_counter()
    log(f"phase 11 (c) in {done_c - done_b:.1f} s")

    # (d) a mesh naming the card twice: a layout check, not a speed-up
    twice = ["cuda:0", "cuda:0"]
    args = (sc["inc"][:n_sub], sc["s0_co_db"][:n_sub], sc["s0_cr_db"][:n_sub],
            sc["dsig_cr"][:n_sub], sc["anc"][:n_sub])
    for mode, shape in (("fused", (2, 1)), ("exact", (1, 2))):
        got = par.sharded_invert_pixels(tables, *args, mesh=par.make_mesh(*shape, devices=twice),
                                        mode=mode)
        ref = invert_pixels(tables, *args, mode=mode, device="cuda")
        if not all(same_bits(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"phase 11: sharded_invert_pixels({mode}, data {shape[0]}, model "
                             f"{shape[1]}) differs from one device")
        log(f"phase 11 sharded_invert_pixels mode={mode}, mesh data {shape[0]} x model "
            f"{shape[1]} on one card: bit-equal to one device on {n_sub} px")
    win, tile = 40, 4096
    centers = np.arange(win // 2, tile // 4 - win // 2, win, dtype=np.int32)
    bins = G._angle_bin_centers(72).astype(np.float32)
    img = synthetic_tile(tile, tile, seed + 1)
    w, r = par.sharded_streaks_histogram(img, centers, centers, win, bins,
                                         par.make_mesh(2, 1, devices=twice))
    ref_w, ref_r = (t.cpu().numpy() for t in G.streaks_histogram_core(
        torch.as_tensor(img, device="cuda"), centers, centers, win, bins))
    dev = max_dev(w.reshape(ref_w.shape), ref_w)
    log(f"phase 11 sharded_streaks_histogram, data 2 on one card, {tile} x {tile} px: "
        f"{dev:.3e} of the largest weight from the one-device core (tolerance "
        f"{STREAKS_RTOL_PATHS:.0e}: float32 sums in any order)")
    if not dev <= STREAKS_RTOL_PATHS or not np.array_equal(r.reshape(ref_r.shape), ref_r):
        raise SystemExit("phase 11: the line-sharded streaks differ from the one-device core")
    log(f"phase 11 (d) in {time.perf_counter() - done_c:.1f} s")
    log("phase 11 card (nvidia-smi name, power.limit):")
    log(card)


# ---------------------- phase 12: the CLI, the trace, the full scene, the rest

DEMO_RMS_MAX = 1.0  # m/s, dual-pol speed against the truth (the JAX demo's scene)
PEAK_TIE_RTOL = 1e-9  # a window whose two largest weights are closer is a tie
PEAK_RTOL = 1e-9  # peak weights, card against CPU in float64 (atomic sums)
SCENE_KEYS = (("inc", "inc"), ("sigma0", "s0_co"), ("sigma0_dual", "s0_cr"),
              ("ancillary_wind", "anc"))
EXAMPLES = ("create_hh_lut", "detrend_roughness", "gmfs_and_luts", "multichip_batch",
            "out_of_core_scene", "streaks_direction", "windspeed_retrieval")


def fused_launches(launches, what, phase):
    """Exit unless ``launches`` has K1 and K2 and no kernel of the unfused
    tail."""
    if not (launches["group_argmin"] and launches["slab_refine_fused"]) \
            or launches["slab_refine"] or launches["crosspol_argmin"]:
        raise SystemExit(f"{phase}: {what} launched {launches}, expected K1 and K2 only")


def cli_on_card(torch, K, sc, tmp, phase):
    """(a): ``xsarsea-tpu-torch invert`` with its defaults (the card, mode
    auto -> fused) on phase 4's scene as a directory of ``.npy`` files, dual
    and mono-pol, each bit-equal to ``invert_from_model`` on the same
    memmaps; then ``list``."""
    from xsarsea_tpu_torch import cli
    from xsarsea_tpu_torch.windspeed.inversion import invert_from_model

    dual, mono = tmp / "scene", tmp / "mono"
    dual.mkdir()
    mono.mkdir()
    for key, field in SCENE_KEYS:
        np.save(dual / f"{key}.npy", sc[field])
        if key != "sigma0_dual":
            (mono / f"{key}.npy").symlink_to(dual / f"{key}.npy")
    mm = {key: np.load(dual / f"{key}.npy", mmap_mode="r") for key, _ in SCENE_KEYS}
    for d, model, keys in ((dual, "gmf_cmod5n,gmf_s1_v2", ("wind_co", "wind_dual")),
                           (mono, "gmf_cmod5n", ("wind",))):
        out = tmp / f"{d.name}_wind.npz"
        K.reset_launch_counts()
        _, seconds = host_seconds(torch, lambda: cli.main(["invert", str(d), str(out),
                                                           "--model", model]))
        launches = K.launch_counts()
        fused_launches(launches, f"the CLI's invert --model {model}", phase)
        got = np.load(out)
        if "," in model:
            ref = invert_from_model(mm["inc"], mm["sigma0"], mm["sigma0_dual"],
                                    ancillary_wind=mm["ancillary_wind"], dsig_cr=0.1,
                                    model=tuple(model.split(",")), device="cuda")
        else:
            ref = (invert_from_model(mm["inc"], mm["sigma0"], ancillary_wind=mm["ancillary_wind"],
                                     dsig_cr=0.1, model=model, device="cuda"),)
        for key, want in zip(keys, ref):
            if not same_bits(got[key], want) or not np.isfinite(got[key]).all():
                raise SystemExit(f"{phase}: the CLI's {key} ({model}) differs from "
                                 "invert_from_model on the same memmaps, or is not finite")
        log(f"{phase} (a) xsarsea-tpu-torch invert {d.name}/ --model {model} (defaults: "
            f"--device cuda, --mode auto): {sc['inc'].size} px from memmapped .npy files to "
            f".npz in {seconds:.3f} s, launches {launches}; {', '.join(keys)} bit-equal to "
            "invert_from_model on the same memmaps")
    cli.main(["list"])


def trace_on_card(torch, tables, dev, tmp, phase):
    """(b): ``utils.trace`` around one device-resident fused call; its trace
    file must name K1's and K2's kernels."""
    from xsarsea_tpu_torch.utils import trace
    from xsarsea_tpu_torch.windspeed.inversion import invert_pixels

    invert_pixels(tables, *dev, device="cuda", device_output=True)  # warm
    with trace(tmp / "trace") as tr:
        invert_pixels(tables, *dev, device="cuda", device_output=True)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {want: sorted({e["name"] for e in kernels if want in e["name"]})
             for want in ("group_argmin", "slab_refine_fused")}
    log(f"{phase} (b) trace of invert_pixels on {dev[0].shape[0]} device-resident px: "
        f"{Path(tr.path).name}, {Path(tr.path).stat().st_size} bytes, {len(events)} events, "
        f"{len(kernels)} kernel events; K1/K2 kernels named: {found}")
    if not all(found.values()):
        raise SystemExit(f"{phase}: the trace does not name K1's and K2's kernels")


def demo_on_card(K, phase):
    """(c): the full-scene demo at its default 10**8 px, into a temporary
    directory removed afterwards."""
    from xsarsea_tpu_torch.scripts import demo_full_scene

    K.reset_launch_counts()
    res = demo_full_scene.main([], log=lambda line: log(f"{phase} (c) demo: {line}"))
    launches = K.launch_counts()
    fused_launches(launches, "the demo", phase)
    temporaries = res["peak_bytes"] - res["output_bytes"]
    log(f"{phase} (c) full-scene demo, {res['px']} px: build {res['build_seconds']:.2f} s, "
        f"inversion from disk {res['seconds']:.2f} s = {res['mpx_s']:.3f} Mpx/s, launches "
        f"{launches}; Python-allocated peak {res['peak_bytes']} bytes (outputs "
        f"{res['output_bytes']}, temporaries {temporaries}), pinned pool "
        f"{res['pinned_bytes']} bytes; dual-pol RMS vs truth {res['rms']:.6f} m/s")
    if not (np.isfinite(res["rms"]) and res["rms"] < DEMO_RMS_MAX):
        raise SystemExit(f"{phase}: the demo's RMS {res['rms']} is not below {DEMO_RMS_MAX}")
    if not temporaries < res["output_bytes"]:
        raise SystemExit(f"{phase}: the demo's temporaries ({temporaries} bytes) are not "
                         f"below its outputs ({res['output_bytes']})")


def peak_on_card(seed, phase, side=2048):
    """(d): ``PlotGradients(hist).peak`` on phase 10's class histogram in
    float64, on the card against ``device="cpu"``."""
    from xsarsea_tpu_torch import DimArray
    from xsarsea_tpu_torch import gradients as G

    base = synthetic_tile(side, side, seed + 2).astype(np.float64)
    da = DimArray(np.stack([base, 0.2 * base]), dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]), "line": np.arange(side) * 10.0,
                          "sample": np.arange(side) * 10.0})
    kw = dict(windows_sizes=[1600, 3200], downscales_factors=[1, 2])
    hist, peak, seconds = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        hist[dev] = G.Gradients(da, device=dev, **kw).histogram
        peak[dev] = G.PlotGradients(hist[dev]).peak
        peak[dev]["angle"].values  # the peak reaches the host: the work is done
        seconds[dev] = time.perf_counter() - t0
    if peak["cuda"]["angle"].data.device.type != "cuda":
        raise SystemExit(f"{phase}: the peak on the card was not computed there")
    top2 = np.sort(hist["cpu"]["weight"].values, axis=-1)[..., -2:]
    tie = ~(top2[..., 1] - top2[..., 0] > PEAK_TIE_RTOL * np.abs(top2[..., 1]))
    got, ref = peak["cuda"]["angle"].values, peak["cpu"]["angle"].values
    bad = int(((got != ref) & ~tie).sum())
    w_got, w_ref = peak["cuda"]["weight"].values, peak["cpu"]["weight"].values
    w_dev = float(np.max(np.abs(w_got - w_ref) / np.abs(w_ref)))
    log(f"{phase} (d) PlotGradients(Gradients(2 x {side}^2, windows [1600, 3200] m, factors "
        f"[1, 2]).histogram).peak, float64: {got.size} windows {peak['cuda']['angle'].dims}, "
        f"card {seconds['cuda']:.2f} s, CPU {seconds['cpu']:.2f} s (histogram included); "
        f"{int(tie.sum())} ties (two largest weights within {PEAK_TIE_RTOL:.0e} relative), "
        f"{int((got != ref).sum())} angles differing, {bad} of them outside a tie; peak weight "
        f"largest relative deviation {w_dev:.3e} (tolerance {PEAK_RTOL:.0e})")
    if bad or not w_dev <= PEAK_RTOL:
        raise SystemExit(f"{phase}: the peak on the card differs from the CPU's")


def scripts_on_card(phase):
    """(e): the four stage and scaling scripts at their defaults."""
    from xsarsea_tpu_torch.scripts import (bench_gather_sizes, bench_scaling, bench_stages,
                                           bench_streaks_stages)

    for mod in (bench_stages, bench_streaks_stages, bench_gather_sizes, bench_scaling):
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        mod.main(log=lambda line, name=name: log(f"{phase} (e) {name}: {line}"))
        log(f"{phase} (e) {name} in {time.perf_counter() - t0:.1f} s")


def examples_on_card(K, phase):
    """(f): the seven examples, ``main()`` each on the card at its default
    size; each raises where its JAX counterpart asserts."""
    import importlib

    for name in EXAMPLES:
        mod = importlib.import_module(f"xsarsea_tpu_torch.examples.{name}")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main()
        launches = {k: v for k, v in K.launch_counts().items() if v}
        log(f"{phase} (f) example {name}: {res} in {time.perf_counter() - t0:.2f} s, "
            f"launches {launches}")
        if name in ("windspeed_retrieval", "multichip_batch"):
            fused_launches(K.launch_counts(), f"example {name}", phase)
        if name == "windspeed_retrieval" and not res["rms"] < 1.0:
            raise SystemExit(f"{phase}: windspeed_retrieval's RMS {res['rms']} is not below 1")
        if name == "streaks_direction" and not abs(res["err"]) < 7.5:
            raise SystemExit(f"{phase}: streaks_direction is {res['err']} deg off")


def phase12(torch, K, sc, tables, card, seed, n_trace=1 << 22):
    """The port's remaining entry points on the card: the CLI, the profiler
    trace, the 10**8-px demo, PlotGradients' peak, the four scripts and the
    seven examples."""
    clock = [time.perf_counter()]

    def step(label):
        now = time.perf_counter()
        log(f"phase 12 ({label}) in {now - clock[0]:.1f} s")
        clock[0] = now

    with tempfile.TemporaryDirectory(prefix="phase12_") as tmp:
        cli_on_card(torch, K, sc, Path(tmp), "phase 12")
        step("a")
        dev = device_inputs(torch, sc, sc["s0_cr_db"])(0, n_trace)
        trace_on_card(torch, tables, dev, Path(tmp), "phase 12")
        del dev
        step("b")
    demo_on_card(K, "phase 12")
    step("c")
    peak_on_card(seed, "phase 12")
    step("d")
    scripts_on_card("phase 12")
    step("e")
    examples_on_card(K, "phase 12")
    step("f")
    log("phase 12 card (nvidia-smi name, power.limit):")
    log(card)


def run(n=1 << 23, n_sub=1 << 16, n_rms=1 << 20, reps=3, through=12, seed=0):
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
    report = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "max_abs_err": 0.0, "library_ms": None}
              for name, (src, rep, _) in KERNELS.items()}
    clock = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        log(f"{phase} done in {now - clock[0]:.1f} s")
        clock[0] = now
        if phase.split()[1] == str(through) and through < 12:
            log(f"stopped after phase {through}, as asked: no result line")
            raise SystemExit(0)

    # phase 1: the card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log("phase 1 card (nvidia-smi name, power.limit):")
    log(card)
    done("phase 1")

    # phase 2: kernel build
    t0 = time.perf_counter()
    lib = K.build_kernels()
    log(f"phase 2 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in K.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    done("phase 2")

    t0 = time.perf_counter()
    sc = make_scene(torch, get_model, n, seed)
    tables = prepare_tables(*models, dtype=torch.float32)
    log(f"scene ({n} px) and high-res tables {tables.co_lut.shape} + {tables.cr_lut.shape} "
        f"in {time.perf_counter() - t0:.1f} s")

    dev_inputs = device_inputs(torch, sc, sc["s0_cr_db"])

    # phase 3: kernels against their plain versions, bit for bit
    calls = hold_on_subsample(torch, K, tables, dev_inputs, n_sub, report, "phase 3")
    hold_on_seams(torch, K, tables, report, "phase 3")
    hold_on_coarse_seams(torch, K, calls["group_argmin"][0][1].shape[1],
                         (155, tables.cr_lut.shape[1]), tables.co_lut.shape[2], report,
                         "phase 3")
    hold_quotient(torch, K, [tables.cr_lut], 1 << 26, "phase 3")
    done("phase 3 (with the scene and tables)")

    # phase 4: the main path, with launch counts
    def main_path():
        return invert_from_model(
            sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"], dsig_co=0.1,
            dsig_cr=0.1, model=models, device="cuda")

    K.reset_launch_counts()
    (wind_co, wind_dual), seconds = host_seconds(torch, main_path)
    launches = K.launch_counts()
    (wind_co, wind_dual), seconds_again = host_seconds(torch, main_path)
    seconds_serial = hold_against_serial_loop(torch, main_path, (wind_co, wind_dual),
                                              lambda w: w, "phase 4")
    for name in ("group_argmin", "slab_refine_fused"):
        if launches[name] == 0:
            raise SystemExit(f"phase 4: kernel {name} was not launched by the main path")
        report[name]["launches"] = launches[name]
    if launches["slab_refine"] or launches["crosspol_argmin"]:
        raise SystemExit("phase 4: the fused tail launched a kernel of the unfused tail")
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
    log(f"phase 4 piece loop, {n} px host in/out: overlapped {seconds:.4f} s (the process's "
        f"first call, which pins its buffers), again {seconds_again:.4f} s; serial "
        f"{seconds_serial:.4f} s; results bit-equal")
    if not 0.341 <= rms <= 0.351:
        raise SystemExit(f"phase 4: rms_vs_truth_noisy_m_s {rms} outside 0.346 +- 0.005")
    done("phase 4")

    # phase 5: device-resident rate, and each kernel beside its plain version
    times, calls = device_rate(torch, K, tables, dev_inputs(0, n), reps)
    rate = n / statistics.median(times) / 1e6
    log(f"phase 5 invert_pixels device-resident f32: {rate:.3f} Mpx/s "
        f"(median of {reps}: {[round(t, 4) for t in times]} s for {n} px)")
    for name, (args, kwargs) in calls.items():
        err, size = hold_against_plain(torch, K, name, args, kwargs, "phase 5")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        time_against_plain(torch, K, name, args, kwargs, report[name])
        log(f"phase 5 {name}: bit-equal to its plain version on {size} outputs at the main "
            f"path's shapes (feats {tuple(feats_of(name, args).shape)}); kernel "
            f"{report[name]['ms']:.3f} ms, plain {report[name]['plain_ms']:.3f} ms per call, "
            f"bound {report[name]['bound_ms']:.3f} ms ({report[name]['bound_by']})"
            f"{sweep_note(torch, K, name, args)}")
    done("phase 5")

    # phase 6: fused against exact on the card
    fused_vs_exact(torch, tables, sc, dev_inputs, n_sub, "phase 6")
    done("phase 6")

    # phase 7: the unfused tail, on LUT-file models with their own incidence axes
    with tempfile.TemporaryDirectory() as tmp:
        own = phase7(torch, K, sc, n, n_sub, n_rms, reps, report, Path(tmp))
    done("phase 7")

    # phase 8: the experiment drivers (K5 cost forms, K6 coarse-pass variants)
    phase8(torch, K, report)
    done("phase 8")

    # phase 9: scene preparation around the inversion, on a labelled scene
    phase9(torch, K, report, card, seed)
    done("phase 9")

    # phase 10: the wind streaks (no hand kernel: the counts above stay as they are)
    phase10(torch, card, seed)
    done("phase 10")

    # phase 11: the fused_exact mode, the margin sweep, parallel/ on one card
    phase11(torch, K, sc, tables, own, report, card, seed, n, n_sub, n_rms, reps)
    done("phase 11")

    # phase 12: the CLI, the trace, the 10**8-px demo, the peak, scripts, examples
    phase12(torch, K, sc, tables, card, seed)
    done("phase 12")

    log(json.dumps({"kernels": list(report.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--through", type=int, default=12, choices=range(3, 13), metavar="N",
                        help="stop after phase N (3-11); the default runs all twelve phases")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the scenes (default 0, which phase 4's RMS gate expects)")
    cli = parser.parse_args()
    sys.exit(run(through=cli.through, seed=cli.seed))
