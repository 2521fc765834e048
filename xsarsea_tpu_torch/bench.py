"""The port's benchmark: one JSON record of the dual-pol inversion's rate and
the rates around it, measured on the card (counterpart of the JAX package's
``bench.py``, under the keys its records use).

Run it on a card: ``python -m xsarsea_tpu_torch.bench``. It prints its
progress on stderr and, as the last line of stdout, one JSON object:

* ``value`` (``headline_mpx_s``): ``_get_invert_fn``'s fused closure on
  device-resident float32 inputs, 2**23 px of :func:`make_scene`'s scene with
  ``gmf_cmod5n`` / ``gmf_s1_v2``, three calls after a warm-up under one host
  clock; ``rms_vs_truth_noisy_m_s``, the dual-pol speed against the true wind
  on the first 2**20 px;
* ``cmod7_mpx_s`` (a synthetic CMOD7 table on its native grid, through the
  KNMI binary reader), ``copol_mpx_s`` (no crosspol LUT: K2 without its
  tail), ``cuda_vs_exact_max_dev_m_s`` (``fused`` against ``exact`` on the
  card, 2**16 px);
* ``streaks_mpx_s``, ``gradients_class_mpx_s``, ``detrend_mpx_s``;
* ``e2e_from_host_mpx_s`` (a ``_LazySource`` of 1,024 x 4,096 px with an
  incidence vector and linear float32 sigma0, results left on the card),
  ``e2e_disk_mpx_s`` (``invert_from_model`` on memmapped ``.npy`` files, host
  results), ``host_prep_mpx_s`` (``_LazySource.streams`` per 2**22-px piece,
  the copies to the card through the pinned pool included);
* ``e2e_from_host_fresh_mpx_s`` and ``e2e_fresh_first_pass_s``: a fresh
  process (``--e2e-child DIR``) on the same memmapped scene, its best of two
  passes and the seconds of its first (the kernels' library loaded from the
  build cache, the LUTs staged);
* ``native_lutio``: whether the native LUT codec ``xsarsea_tpu_torch._lutio``
  imports (built in place with ``python setup.py build_ext --inplace`` when
  it does not), and ``native_cmod7_decode_bit_equal``, its CMOD7 decode of the
  synthetic table against the Python decode;
* ``backend``, ``mode``, ``card`` (``nvidia-smi``'s name and power limit),
  ``launches`` (the kernel launches of each section).

Each section runs under the ``BENCH_BUDGET_S`` deadline (default 460 s from
the start of :func:`main`): a section whose estimate exceeds what is left is
skipped and listed under ``skipped_sections``. A section that raises is listed
under ``failed_sections`` and the process exits 1 after printing the record;
SIGTERM or SIGINT prints the partial record and exits 128 + the signal.

``device="cpu"`` (``--device cpu``) runs the kernels' plain versions in the
``exact`` mode, for the tests; the default ``cuda`` raises without a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from xsarsea_tpu_torch.detrend import sigma0_detrend
from xsarsea_tpu_torch.io.lut_io import native_codec
from xsarsea_tpu_torch.models import get_model, register_cmod7
from xsarsea_tpu_torch.models import cmod7 as _cmod7
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.scripts.bench_streaks_stages import synthetic_tile
from xsarsea_tpu_torch.utils import resolve_device
from xsarsea_tpu_torch.windspeed.inversion import (_get_invert_fn, _invert_source, _LazySource,
                                                   invert_from_model, invert_pixels,
                                                   prepare_tables)

MODELS = ("gmf_cmod5n", "gmf_s1_v2")
CMOD7_STEPS = {"inc_step": 0.1, "wspd_step": 0.1, "phi_step": 1.0}
REPS = 3
PIECE = 1 << 22
NX_E2E = 4096  # scene width of the from-host and from-disk sections
ROOT = Path(__file__).resolve().parent.parent  # the checkout (setup.py) or site-packages


def log(msg):
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _mode(device):
    return "fused" if device.type == "cuda" else "exact"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launched():
    """The kernel launches since the last reset, those that happened."""
    return {k: v for k, v in K.launch_counts().items() if v}


def card_name():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class Record:
    """The one JSON record, filled section by section under a wall-clock
    budget, and what a signal must stop: child processes and temporary
    directories."""

    def __init__(self, budget_s):
        self.start = time.time()
        self.deadline = self.start + budget_s
        self.results = {}
        self.launches = {}
        self.skipped = []
        self.failed = []
        self.children = []
        self.tmpdirs = []
        self._emitted = False

    def remaining(self):
        return self.deadline - time.time()

    def emit(self):
        """Print the record from whatever has been measured (once)."""
        if self._emitted:
            return
        self._emitted = True
        r = dict(self.results)
        mpx_s = r.pop("headline_mpx_s", None)
        parity = r.get("cuda_vs_exact_max_dev_m_s")
        rms = r.get("rms_vs_truth_noisy_m_s")
        e2e = r.get("e2e_from_host_mpx_s")
        wall = time.time() - self.start
        notes = "".join([
            f"{r.get('backend', '?')}, mode={r.get('mode', '?')}, ",
            f"fused==exact max dev {parity:g} m/s, " if parity is not None else "",
            f"RMS vs truth on noisy synthetic scene {rms:.3f} m/s [not a parity metric], "
            if rms is not None else "",
            f"from-host e2e {e2e:.2f} Mpx/s, " if e2e is not None else "",
            f"wall {wall:.0f}s"])
        out = {"metric": f"dual-pol inversion throughput, device-resident inputs ({notes})",
               "value": mpx_s, "unit": "Mpx/s", **r, "wall_s": wall, "launches": self.launches}
        if self.skipped:
            out["skipped_sections"] = self.skipped
        if self.failed:
            out["failed_sections"] = self.failed
        print(json.dumps(out), flush=True)

    def section(self, name, est_cost_s, fn, required=False):
        """Run ``fn()`` as section ``name``: skipped when less than
        ``est_cost_s`` is left (unless ``required``), recorded under
        ``failed_sections`` when it raises; its kernel launches go to
        ``launches[name]`` unless ``fn`` put its own there."""
        if not required and self.remaining() < est_cost_s:
            self.skipped.append(f"{name} (budget: {self.remaining():.0f}s left, "
                                f"needs ~{est_cost_s:.0f}s)")
            log(f"SKIP {name} ({self.remaining():.0f}s left)")
            return
        K.reset_launch_counts()
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the record names the failed section and runs on
            traceback.print_exc()
            self.failed.append(f"{name} ({type(e).__name__}: {e})")
            log(f"FAIL {name}: {type(e).__name__}: {e}")
            return
        finally:
            self.launches.setdefault(name, _launched())
        log(f"{name} done in {time.time() - t0:.1f}s ({self.remaining():.0f}s left)")

    def on_signal(self, signum, frame):
        """Stop the children, print the partial record, exit 128 + signum."""
        log(f"signal {signum} after {time.time() - self.start:.0f}s: emitting the partial record")
        for proc in self.children:
            proc.kill()
        for d in self.tmpdirs:
            shutil.rmtree(d, ignore_errors=True)
        self.failed.append(f"interrupted_by_signal_{signum}")
        self.emit()
        os._exit(128 + signum)


def make_scene(n, seed=0, device="cuda"):
    """The benchmark scene (``bench.py:444-462``): incidence U(18, 47) deg,
    speed U(0.5, 45) m/s, direction U(0, 360) deg, sigma0 forward-modelled
    in float64 on ``device`` with ``gmf_cmod5n`` and ``gmf_s1_v2``, an
    ancillary wind of the speed plus N(0, 1.5) clipped at 0.2, ``dsig_cr``
    0.1; host numpy arrays, with the sigma0 of the from-host sections
    (linear float32 from the dB values, ``s0_co_lin32``/``s0_cr_lin32``)."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    dev = [torch.as_tensor(a, device=device) for a in (inc, wspd, phi)]
    s0_co = get_model(MODELS[0])(*dev, broadcast=True).cpu().numpy()
    s0_cr = get_model(MODELS[1])(dev[0], dev[1], broadcast=True).cpu().numpy()
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    sc = dict(inc=inc, wspd=wspd, phi=phi, s0_co=s0_co, s0_cr=s0_cr, anc=anc,
              s0_co_db=10 * np.log10(s0_co + 1e-15), s0_cr_db=10 * np.log10(s0_cr + 1e-15),
              dsig_cr=np.full(n, 0.1))
    # the from-host sections' wire format: linear float32 sigma0
    for pol in ("co", "cr"):
        sc[f"s0_{pol}_lin32"] = np.power(10.0, sc[f"s0_{pol}_db"] / 10.0).astype(np.float32)
    return sc


def write_synthetic_cmod7():
    """A CMOD7 table file synthesized from ``gmf_cmod5n`` on CMOD7's native
    grid (250 wspd x 73 phi x 51 incidence), in the KNMI binary form (one
    Fortran-ordered float32 record between two markers), in a new temporary
    directory (``bench.py:271-301``; the real file is not fetched). Returns
    the ``cmod7`` directory that ``register_cmod7`` takes."""
    wspd = np.arange(0.2, 50.0 + 0.2, 0.2)
    phi = np.arange(0.0, 180.0 + 2.5, 2.5)
    inc = np.arange(16.0, 66.0 + 1.0, 1.0)
    vals = get_model(MODELS[0])(inc, wspd, phi).values  # (incidence, wspd, phi)
    table = np.ascontiguousarray(vals.transpose(1, 2, 0))  # (wspd, phi, incidence)
    flat = np.concatenate([np.array([0.0], np.float32),
                           table.astype(np.float32).reshape(-1, order="F"),
                           np.array([0.0], np.float32)])
    d = Path(tempfile.mkdtemp(prefix="cmod7_bench_")) / "cmod7"
    d.mkdir()
    flat.astype("<f4").tofile(d / _cmod7.TABLE_FILE)
    return d


def ensure_native_lutio():
    """(True, None) when ``xsarsea_tpu_torch._lutio`` imports, building it in
    place first (``python setup.py build_ext --inplace`` in the checkout) when
    it does not; else (False, why)."""
    if native_codec() is not None:
        return True, None
    if not (ROOT / "setup.py").exists():
        return False, f"not built, and no setup.py in {ROOT} to build it"
    proc = subprocess.run([sys.executable, "setup.py", "build_ext", "--inplace"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    # the package directory may sit in the import system's cache from before
    # the build: without invalidation the new module would stay invisible
    importlib.invalidate_caches()
    if native_codec() is not None:
        return True, None
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-5:]
    return False, f"setup.py build_ext exited {proc.returncode}: {' | '.join(tail)}"


def check_native_cmod7(table_dir):
    """True when the native codec's CMOD7 decode equals the Python decode bit
    for bit; raises where they differ."""
    path = str(Path(table_dir) / _cmod7.TABLE_FILE)
    got, ref = native_codec().decode_cmod7(path), _cmod7.decode_python(path)
    if got.dtype != ref.dtype or got.shape != ref.shape or got.tobytes() != ref.tobytes():
        raise AssertionError(f"the native CMOD7 decode ({got.dtype}, {got.shape}) differs "
                             f"from the Python decode ({ref.dtype}, {ref.shape})")
    return True


def write_scene_dir(scene_dir, sc, lut_steps):
    """The scene as memmappable ``.npy`` files (f64 incidence, linear f32
    sigma0, complex ancillary wind) and the tables' LUT steps, for
    :func:`invert_from_model` and the fresh child."""
    arrays = {"inc": sc["inc"], "s0_co": sc["s0_co_lin32"], "s0_cr": sc["s0_cr_lin32"],
              "anc": sc["anc"]}
    for name, arr in arrays.items():
        np.save(os.path.join(scene_dir, name + ".npy"), arr)
    with open(os.path.join(scene_dir, "tables.json"), "w") as f:
        json.dump(lut_steps, f)


def e2e_child(scene_dir, device="cuda"):
    """Fresh-process rate from disk: the scene directory of
    :func:`write_scene_dir`, memmapped, through ``_invert_source`` with the
    results on the device, best of two passes. Prints one JSON line: the
    rate, the first pass's seconds, the seconds to build the tables and the
    kernel launches."""
    device = resolve_device(device)

    def load(name):
        return np.load(os.path.join(scene_dir, name + ".npy"), mmap_mode="r")

    inc, s0_co, s0_cr, anc = (load(k) for k in ("inc", "s0_co", "s0_cr", "anc"))
    with open(os.path.join(scene_dir, "tables.json")) as f:
        lut_steps = json.load(f)
    n = inc.shape[0]
    t0 = time.perf_counter()
    tables = prepare_tables(*MODELS, dtype=torch.float32, **lut_steps)
    tables_s = time.perf_counter() - t0
    src = _LazySource((n,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc)
    K.reset_launch_counts()
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        co, dual = _invert_source(tables, src, mode=_mode(device), device=device,
                                  device_output=True)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        del co, dual
    print(json.dumps({"e2e_mpx_s": n / min(seconds) / 1e6, "first_pass_s": seconds[0],
                      "tables_s": tables_s, "launches": _launched()}), flush=True)


def run_child(record, scene_dir, device, timeout_s):
    """Run :func:`e2e_child` in a fresh interpreter; its JSON line."""
    cmd = [sys.executable, "-m", "xsarsea_tpu_torch.bench", "--e2e-child", scene_dir,
           "--device", str(device)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    record.children.append(proc)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"the fresh child did not finish in {timeout_s:.0f} s") from None
    finally:
        record.children.remove(proc)
    if proc.returncode != 0:
        raise RuntimeError(f"the fresh child exited {proc.returncode}: "
                           f"{' | '.join(err.strip().splitlines()[-5:])}")
    return json.loads(out.strip().splitlines()[-1])


def _rate(fn, px, device, reps=REPS):
    """Mpx/s of ``reps`` calls of ``fn()`` after a warm-up, one host clock
    around them, ending in a synchronize."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return px * reps / (time.perf_counter() - t0) / 1e6


def bench_detrend(device, shape):
    """``sigma0_detrend`` numpy in, numpy out (both copies included), best
    of 3 after a warm-up (``bench.py:171-189``)."""
    ny, nx = shape
    rng = np.random.default_rng(3)
    inc2d = np.tile(np.linspace(18.0, 47.0, nx), (ny, 1))
    s0 = rng.uniform(1e-3, 0.2, (ny, nx))
    sigma0_detrend(s0, inc2d, device=device)
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        out = sigma0_detrend(s0, inc2d, device=device)
        best = max(best, ny * nx / (time.perf_counter() - t0) / 1e6)
    if not np.isfinite(out).all():
        raise ValueError("sigma0_detrend gave non-finite values")
    return best


def bench_streaks(device, tile):
    """``streaks_histogram_core`` on a device-resident ``tile``² tile, 40-px
    windows of local-gradient pixels, 72 bins (``bench.py:192-227``)."""
    from xsarsea_tpu_torch import gradients as G

    win = 40
    n_lg = tile // 4
    centers = np.arange(win // 2, n_lg - win // 2, win, dtype=np.int32)
    bins = G._angle_bin_centers(72).astype(np.float32)
    img = synthetic_tile(tile, tile, seed=1)
    img_d, cl, bins_d = (torch.as_tensor(a, device=device) for a in (img, centers, bins))
    return _rate(lambda: G.streaks_histogram_core(img_d, cl, cl, win, bins_d, device=device),
                 img.size, device)


def bench_gradients_class(device, side):
    """``Gradients(...).histogram`` with windows 1,600 and 3,200 m and
    downscale factors 1 and 2 on 2 x ``side``² px at 10 m, device-resident,
    construction included (``bench.py:230-268``)."""
    from xsarsea_tpu_torch import DimArray
    from xsarsea_tpu_torch.gradients import Gradients

    base = synthetic_tile(side, side, seed=2)
    img_d = torch.as_tensor(np.stack([base, 0.2 * base]), device=device)
    da = DimArray(img_d, dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]), "line": np.arange(side) * 10.0,
                          "sample": np.arange(side) * 10.0})
    return _rate(lambda: Gradients(da, windows_sizes=[1600, 3200],
                                   downscales_factors=[1, 2]).histogram,
                 img_d.numel(), device)


def main(device="cuda", n=1 << 23, tile=4096, class_side=2048, detrend_shape=(4096, 2048),
         lut_steps=None):
    """Run every section and print the record; returns the exit code (1 when
    a section failed). ``n``, ``tile``, ``class_side``, ``detrend_shape`` and
    ``lut_steps`` (``to_lut`` steps of every table, the high-res defaults when
    None) are the sizes; the tests shrink them on the CPU."""
    device = resolve_device(device)
    budget = float(os.environ.get("BENCH_BUDGET_S", "460"))
    record = Record(budget)
    old = {s: signal.signal(s, record.on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        _run(record, device, n, tile, class_side, detrend_shape, dict(lut_steps or {}))
    except Exception as e:  # noqa: BLE001 - salvage what was measured, and fail
        traceback.print_exc()
        record.failed.append(f"crashed: {type(e).__name__}: {e}")
    finally:
        for d in record.tmpdirs:
            shutil.rmtree(d, ignore_errors=True)
        for s, handler in old.items():
            signal.signal(s, handler)
    record.emit()
    return 1 if record.failed else 0


def _run(record, device, n, tile, class_side, detrend_shape, lut_steps):
    R = record.results
    mode = _mode(device)
    R["backend"], R["mode"], R["px"] = device.type, mode, n
    R["card"] = card_name() if device.type == "cuda" else None

    cmod7_dir = write_synthetic_cmod7()
    record.tmpdirs.append(str(cmod7_dir.parent))

    def native():
        R["native_lutio"], why = ensure_native_lutio()
        if why is not None:
            R["native_lutio_error"] = why
        else:
            R["native_cmod7_decode_bit_equal"] = check_native_cmod7(cmod7_dir)

    record.section("native_lutio", 30, native)

    def detrend():
        R["detrend_mpx_s"] = bench_detrend(device, detrend_shape)

    record.section("detrend", 20, detrend)

    sc = make_scene(n, 0, device)
    tables = prepare_tables(*MODELS, dtype=torch.float32, **lut_steps)
    dev = [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
           for a in (sc["inc"], sc["s0_co_db"], sc["s0_cr_db"], sc["dsig_cr"], sc["anc"].real,
                     sc["anc"].imag)]
    dev.append(torch.tensor(0.1, dtype=torch.float32, device=device))

    def device_rate(tabs):
        fn = _get_invert_fn(tabs, 8192, mode, device)
        return _rate(lambda: fn(*dev), n, device)

    def headline():
        R["headline_mpx_s"] = device_rate(tables)
        ns = min(n, 1 << 20)
        _, dual = invert_pixels(tables, *(sc[k][:ns] for k in ("inc", "s0_co_db", "s0_cr_db",
                                                                "dsig_cr", "anc")),
                                mode=mode, device=device)
        R["rms_vs_truth_noisy_m_s"] = float(
            np.sqrt(np.nanmean((np.abs(dual) - sc["wspd"][:ns]) ** 2)))

    record.section("headline", 0, headline, required=True)

    def cmod7():
        register_cmod7(str(cmod7_dir))
        tables7 = prepare_tables("gmf_cmod7", MODELS[1], dtype=torch.float32,
                                 **{**CMOD7_STEPS, **lut_steps})
        R["cmod7_mpx_s"] = device_rate(tables7)

    record.section("cmod7", 30, cmod7)

    def copol():
        R["copol_mpx_s"] = device_rate(prepare_tables(MODELS[0], None, dtype=torch.float32,
                                                      **lut_steps))

    record.section("copol", 20, copol)

    def parity():
        ns = min(n, 1 << 16)
        sub = tuple(sc[k][:ns] for k in ("inc", "s0_co_db", "s0_cr_db", "dsig_cr", "anc"))
        fused = invert_pixels(tables, *sub, mode="fused", device=device)
        exact = invert_pixels(tables, *sub, mode="exact", device=device, chunk_size=1024)
        R["cuda_vs_exact_max_dev_m_s"] = max(
            float(np.nanmax(np.abs(np.nan_to_num(np.abs(a) - np.abs(b)))))
            for a, b in zip(fused, exact))

    record.section("parity", 30, parity)
    del dev

    def streaks():
        R["streaks_mpx_s"] = bench_streaks(device, tile)

    record.section("streaks", 20, streaks)

    def gradients_class():
        R["gradients_class_mpx_s"] = bench_gradients_class(device, class_side)

    record.section("gradients_class", 30, gradients_class)

    # the from-host and from-disk sections: the production wire format, linear
    # f32 sigma0 (converted to dB on the card), a scalar dsig_cr, incidence as
    # a vector along the samples; at most 2**22 px
    n_e2e = min(n, PIECE)
    ny, nx = (n_e2e // NX_E2E, NX_E2E) if n_e2e >= NX_E2E else (1, n_e2e)
    npx = ny * nx
    inc_vec = np.linspace(18.0, 47.0, nx).astype(np.float32)

    def e2e_from_host():
        src = _LazySource((ny, nx), inc_vec,
                          s0_co=sc["s0_co_lin32"][:npx].reshape(ny, nx),
                          s0_cr=sc["s0_cr_lin32"][:npx].reshape(ny, nx),
                          dsig_cr=0.1, anc=sc["anc"][:npx].reshape(ny, nx))
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            co, dual = _invert_source(tables, src, mode=mode, device=device, device_output=True)
            _sync(device)
            best = max(best, npx / (time.perf_counter() - t0) / 1e6)
            del co, dual
        R["e2e_from_host_mpx_s"] = best

    record.section("e2e_from_host", 20, e2e_from_host)

    scene_dir = tempfile.mkdtemp(prefix="bench_e2e_")
    record.tmpdirs.append(scene_dir)
    write_scene_dir(scene_dir, sc, lut_steps)

    def e2e_disk():
        def mm(name):
            arr = np.load(os.path.join(scene_dir, name + ".npy"), mmap_mode="r")
            return arr[:npx].reshape(ny, nx)

        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            co, dual = invert_from_model(mm("inc"), mm("s0_co"), mm("s0_cr"),
                                         ancillary_wind=mm("anc"), dsig_cr=0.1, model=MODELS,
                                         mode=mode, device=device, **lut_steps)
            best = max(best, npx / (time.perf_counter() - t0) / 1e6)
            del co, dual
        R["e2e_disk_mpx_s"] = best

    record.section("e2e_disk", 30, e2e_disk)

    def host_prep():
        src = _LazySource((n,), sc["inc"], s0_co=sc["s0_co_lin32"], s0_cr=sc["s0_cr_lin32"],
                          dsig_cr=0.1, anc=sc["anc"], device_db=True)
        t0 = time.perf_counter()
        for lo in range(0, n, PIECE):
            src.streams(lo, min(lo + PIECE, n), device, torch.float32)
        _sync(device)
        R["host_prep_mpx_s"] = n / (time.perf_counter() - t0) / 1e6

    record.section("host_prep", 10, host_prep)

    def e2e_fresh():
        out = run_child(record, scene_dir, device, min(240, max(60, record.remaining())))
        R["e2e_from_host_fresh_mpx_s"] = out["e2e_mpx_s"]
        R["e2e_fresh_first_pass_s"] = out["first_pass_s"]
        R["e2e_fresh_tables_s"] = out["tables_s"]
        record.launches["e2e_fresh"] = out["launches"]

    record.section("e2e_fresh", 60, e2e_fresh)


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    parser.add_argument("--e2e-child", metavar="DIR",
                        help="time one fresh process on the scene directory DIR")
    args = parser.parse_args(argv)
    if args.e2e_child:
        e2e_child(args.e2e_child, args.device)
        return 0
    return main(device=args.device)


if __name__ == "__main__":
    sys.exit(cli())
