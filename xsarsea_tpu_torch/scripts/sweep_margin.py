"""Sweep the fused mode's coarse grid spacing against its refine margin.

Port of ``scripts/sweep_margin.py``. The fused mode's first pass (K1) finds
each pixel's wind-speed group on a coarse grid (``_COARSE_DW`` m/s x
``_COARSE_DPHI`` deg); the slab refine (K2, or K3) then searches ``WGROUP +
2 * margin`` LUT rows around that group. A coarser grid makes K1 cheaper and
drifts the group further from the true minimum's; a larger margin absorbs the
drift at the slab's cost, linear in its rows. For each (dw, dphi, margin) of
the JAX script's list this prints the rate and the pixels whose copol or
dual-pol wind differs from the ``fused_exact`` mode's (K1 on the full grid,
a 32-row slab: the fused mode's ground truth).

Data, as the JAX script's: 2**22 adversarial pixels from seed 7 (incidence
U(17, 49) deg, speed U(0.3, 48) m/s, direction U(0, 360) deg, ancillary
speed noise N(0, 1.5)), sigma0 forward-modelled with ``gmf_cmod5n`` and
``gmf_s1_v2`` in float64 on the device, the high-resolution tables, float32,
device-resident. The JAX script's ``splits`` has no counterpart: the port's
coarse pass is direct form. Margins are multiples of 8. No default changes.

Run: ``python -m xsarsea_tpu_torch.scripts.sweep_margin`` on the card
(``SWEEP_ONLY=0,8`` runs configurations by index). :func:`main` runs the
plain kernel versions on the CPU only when called with ``device="cpu"``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.scripts import device_of
from xsarsea_tpu_torch.windspeed import inversion as inv

N = 1 << 22
DEFAULT = (0.8, 4.0, 16)  # the fused mode's (_COARSE_DW, _COARSE_DPHI, _COARSE_MARGIN)
# the JAX script's (dw, dphi, margin) configurations, in its order, each once
CONFIGS = [
    (0.2, 8.0, 24),
    (0.2, 4.0, 16),
    (0.2, 4.0, 8),
    (0.4, 2.0, 8),
    (0.2, 2.0, 8),
    (0.8, 2.0, 8),
    (0.8, 2.0, 16),
    (1.6, 2.0, 16),
    DEFAULT,
    (1.6, 4.0, 16),
    (0.8, 8.0, 16),
    (1.6, 4.0, 8),
    (0.8, 4.0, 8),
    (1.6, 8.0, 16),
]


def make_pixels(n, device):
    """The adversarial pixels as float32 tensors on ``device``: (inc,
    s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im)."""
    rng = np.random.default_rng(7)
    inc = rng.uniform(17.0, 49.0, n)
    wspd = rng.uniform(0.3, 48.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    f64 = [torch.as_tensor(a, device=device) for a in (inc, wspd, np.abs(((phi + 180) % 360)
                                                                          - 180))]
    s0_co = get_model("gmf_cmod5n")(*f64, broadcast=True)
    s0_cr = get_model("gmf_s1_v2")(f64[0], f64[1], broadcast=True)
    cols = [f64[0], 10 * torch.log10(s0_co + 1e-15), 10 * torch.log10(s0_cr + 1e-15),
            torch.full_like(f64[0], 0.1), torch.as_tensor(anc.real, device=device),
            torch.as_tensor(anc.imag, device=device)]
    return [c.to(torch.float32).contiguous() for c in cols]


def _run(fn, pixels, dsig, reps, device):
    """(complex co, complex dual) on the host and Mpx/s over ``reps`` calls
    after a warm-up, host clock around synchronized work."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn(*pixels, dsig)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*pixels, dsig)
    sync()
    rate = pixels[0].shape[0] * reps / (time.perf_counter() - t0) / 1e6
    co_re, co_im, du_re, du_im = (t.cpu().numpy().astype(np.float64) for t in out)
    return co_re + 1j * co_im, du_re + 1j * du_im, rate


def _flips(got, ref):
    return int(np.sum(~((got == ref) | (np.isnan(got.real) & np.isnan(ref.real)))))


def _max_dspeed(got, ref):
    return float(np.nan_to_num(np.nanmax(np.abs(np.abs(got) - np.abs(ref)))))


def main(n=N, device="cuda", configs=None, reps=2, table_kwargs=None, log=print):
    """Sweep ``configs`` (default :data:`CONFIGS`) on ``n`` pixels; returns
    ``{"reference_mpx_s": rate, "rows": [...]}``, a row per configuration:
    its ``config``, ``mpx_s``, ``flips_co``/``flips_dual`` against
    ``fused_exact`` and the largest speed deviation of each. The module's
    knobs are restored afterwards."""
    dev = device_of(device)
    configs = CONFIGS if configs is None else configs
    tables = inv.prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32,
                                **(table_kwargs or {}))
    pixels = make_pixels(n, dev)
    dsig = torch.tensor(0.1, dtype=torch.float32, device=dev)
    ref_co, ref_du, ref_rate = _run(inv._make_fused_invert_fn(tables, dev, coarse=False),
                                    pixels, dsig, reps, dev)
    log(f"fused_exact reference: {ref_rate:.3f} Mpx/s ({n} px)")
    base = (inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN)
    rows = []
    try:
        for dw, dphi, margin in configs:
            inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN = dw, dphi, margin
            co, du, rate = _run(inv._make_fused_invert_fn(tables, dev), pixels, dsig, reps, dev)
            row = {"config": (dw, dphi, margin), "mpx_s": rate, "flips_co": _flips(co, ref_co),
                   "flips_dual": _flips(du, ref_du), "max_dspeed_co": _max_dspeed(co, ref_co),
                   "max_dspeed_dual": _max_dspeed(du, ref_du)}
            rows.append(row)
            tag = " (default)" if row["config"] == DEFAULT else ""
            log(f"dw={dw} dphi={dphi} margin={margin}{tag}: {rate:.3f} Mpx/s, "
                f"flips co={row['flips_co']} dual={row['flips_dual']} "
                f"({(row['flips_co'] + row['flips_dual']) / (2 * n):.1e}), max|dspeed| "
                f"co={row['max_dspeed_co']:.3f} dual={row['max_dspeed_dual']:.3f} m/s")
    finally:
        inv._COARSE_DW, inv._COARSE_DPHI, inv._COARSE_MARGIN = base
    return {"reference_mpx_s": ref_rate, "rows": rows}


if __name__ == "__main__":
    only = os.environ.get("SWEEP_ONLY")
    main(configs=None if not only else [CONFIGS[int(i)] for i in only.split(",")])
