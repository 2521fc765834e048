"""Full-scene demo: invert 10^8 px end to end from disk (BASELINE #3 scale).

Port of ``scripts/demo_full_scene.py``. Forward-models a Sentinel-1-EW-sized
dual-pol scene (default 10^8 px, 12,207 x 8,192) band by band into on-disk
``.npy`` memmaps (incidence, copol and crosspol sigma0, the true speed as
float32, the ancillary wind as complex64: 24 bytes a pixel), the GMFs
evaluated on the device in float64; then runs the public
``invert_from_model`` on the memmaps. The streamed piece pipeline keeps the
host's Python-allocated temporaries at O(piece) beside the outputs (two
complex64 scenes) and the card's memory at O(piece), whatever the scene's
size. Prints the rate from disk, the Python-allocated peak with the
temporaries beside the outputs and the pinned staging pool (which
``tracemalloc`` does not see), and the dual-pol RMS against the truth.

Run: ``python -m xsarsea_tpu_torch.scripts.demo_full_scene [--px N] [--dir D]
[--skip-build] [--device cuda|cpu]`` (without ``--dir`` the scene goes to a
temporary directory removed afterwards).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
import tracemalloc

import numpy as np
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.utils import resolve_device, staging

PX = 100_000_000
NX = 8192
MODELS = ("gmf_cmod5n", "gmf_s1_v2")
KEYS = (("inc", np.float32), ("s0_co", np.float32), ("s0_cr", np.float32),
        ("anc", np.complex64), ("wspd", np.float32))


def build_scene(d, n, nx=NX, device="cuda"):
    """Forward-model the scene in 4M-px bands straight into memmaps under
    ``d``; returns its (ny, nx) shape. The random draws, shapes and dtypes
    are the JAX script's; each band's sigma0 is evaluated on ``device`` in
    float64 and stored as float32."""
    dev = resolve_device(device)
    ny = n // nx
    if ny < 1:
        raise ValueError(f"a scene of {n} px has no line of {nx} samples")
    shape = (ny, nx)
    os.makedirs(d, exist_ok=True)
    mm = {k: np.lib.format.open_memmap(os.path.join(d, f"{k}.npy"), mode="w+", dtype=dt,
                                       shape=shape) for k, dt in KEYS}
    co, cr = (get_model(m) for m in MODELS)
    rng = np.random.default_rng(0)
    rows = max(1, (1 << 22) // nx)
    inc_row = np.linspace(19.0, 47.0, nx, dtype=np.float32)
    for r0 in range(0, ny, rows):
        r1 = min(r0 + rows, ny)
        m = (r1 - r0, nx)
        wspd = rng.uniform(0.5, 45.0, m).astype(np.float32)
        phi = rng.uniform(-180.0, 180.0, m).astype(np.float32)
        inc = np.broadcast_to(inc_row, m) + rng.normal(0, 0.02, m)
        mm["inc"][r0:r1] = inc
        mm["wspd"][r0:r1] = wspd
        inc_t, wspd_t, phi_t = (torch.as_tensor(np.asarray(a, np.float64), device=dev)
                                for a in (inc, wspd, np.abs(phi)))
        mm["s0_co"][r0:r1] = co(inc_t, wspd_t, phi_t, broadcast=True).cpu().numpy()
        mm["s0_cr"][r0:r1] = cr(inc_t, wspd_t, broadcast=True).cpu().numpy()
        mm["anc"][r0:r1] = ((wspd + rng.normal(0, 1.5, m)).clip(0.2)
                            * np.exp(1j * np.deg2rad(phi))).astype(np.complex64)
    for v in mm.values():
        v.flush()
    return shape


def invert_scene(d, device="cuda", log=print):
    """Invert the memmapped scene under ``d``; returns the run's numbers.
    The tables are built first (set-up), outside the traced allocations."""
    from xsarsea_tpu_torch.windspeed import invert_from_model, prepare_tables

    dev = resolve_device(device)
    prepare_tables(*MODELS, dtype=torch.float32 if dev.type == "cuda" else torch.float64)
    mm = {k: np.load(os.path.join(d, f"{k}.npy"), mmap_mode="r") for k, _ in KEYS}
    n = mm["inc"].size
    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        wind_co, wind_dual = invert_from_model(
            mm["inc"], mm["s0_co"], mm["s0_cr"], ancillary_wind=mm["anc"], dsig_cr=0.1,
            model=MODELS, device=dev)
        seconds = time.perf_counter() - t0
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    outputs = wind_co.nbytes + wind_dual.nbytes
    rms = float(np.sqrt(np.nanmean((np.abs(wind_dual[::97]) - mm["wspd"][::97]) ** 2)))
    pinned = staging.pool().bytes
    log(f"inverted {n / 1e6:.0f} Mpx end-to-end (disk -> wind) in {seconds:.2f} s = "
        f"{n / seconds / 1e6:.2f} Mpx/s on {dev}")
    log(f"python-allocated peak: {peak / 1e9:.2f} GB (outputs {outputs / 1e9:.2f} GB -> "
        f"temporaries {(peak - outputs) / 1e9:.2f} GB); pinned staging pool "
        f"{pinned / 1e6:.0f} MB (not seen by tracemalloc)")
    log(f"dual-pol retrieval RMS vs truth: {rms:.3f} m/s")
    return {"px": n, "seconds": seconds, "mpx_s": n / seconds / 1e6, "peak_bytes": peak,
            "output_bytes": outputs, "pinned_bytes": pinned, "rms": rms}


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--px", type=int, default=PX)
    ap.add_argument("--dir", default=None,
                    help="scene directory (default: a temporary one, removed afterwards)")
    ap.add_argument("--skip-build", action="store_true",
                    help="invert the scene already under --dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.skip_build and args.dir is None:
        ap.error("--skip-build needs --dir")
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="fullscene_") as tmp:
        d = args.dir or tmp
        build_s = 0.0
        if not args.skip_build:
            t0 = time.perf_counter()
            shape = build_scene(d, args.px, device=device)
            build_s = time.perf_counter() - t0
            log(f"scene built: {shape} ({shape[0] * shape[1] / 1e6:.0f} Mpx) in "
                f"{build_s:.1f} s -> {d}")
        res = invert_scene(d, device, log=log)
    res["build_seconds"] = build_s
    return res


if __name__ == "__main__":
    main()
