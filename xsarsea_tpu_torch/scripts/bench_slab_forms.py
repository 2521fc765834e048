"""Cost-form experiment for the slab-refine sweep (K5), on the GPU.

Port of ``scripts/bench_slab_forms.py``. The slab sweep evaluates, per
(pixel, LUT entry), the direct-form cost

    j = ((l - s0) * inv_dsig)**2 + (u/2 - ma/2)**2 + (v/2 - mz/2)**2

(9 FP32 operations). Two rewrites trade rounding for operations:

- ``prescaled`` (8): fold the scalar ``inv_dsig`` into the LUT once
  (``l' = l * inv_dsig``, f32) and into the pixel's ``s0' = s0 * inv_dsig``;
- ``expanded_uv`` (7): also expand the wind terms against a row operand
  ``kr = (u/2)**2 + (v/2)**2`` and the rows ``-2 * u/2``, ``-2 * v/2``:
  ``j = (l' - s0')**2 + kr - u*ma/2 - v*mz/2``, dropping the per-pixel
  constant ``(ma/2)**2 + (mz/2)**2``. The exact argmin is unchanged; f32
  near-ties can flip.

On a 2**23-pixel seed-0 scene (``gmf_cmod5n`` copol only, ``dsig_co``
0.1) bucketed by the port's own stage 1 (nearest incidence band, K1, the
re-bucketing by (band, group)), it times the three forms of K5 on both of
its loops, the shared sweep K2 and K3 run and the one-pixel-a-thread loop
they ran before it, in turns (CUDA events, medians of 3 after a warm-up),
and counts each rewrite's argmin flips against ``direct``, adjudicated with
the float64 direct-form cost: is the flipped winner better, worse, or an
exact float64 tie?

Run: ``python -m xsarsea_tpu_torch.scripts.bench_slab_forms``. It needs a
CUDA device; :func:`main` runs the plain versions on the CPU only when
called with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.bucketing import bucket_by_band, nearest_index_sorted
from xsarsea_tpu_torch.scripts import cuda_ms_turns, device_of
from xsarsea_tpu_torch.windspeed import inversion as inv

N = 1 << 23
REPS = 3
DSIG_CO = 0.1
_BIG_IDX = 2 ** 30


def draw_scene(n):
    """The JAX script's seed-0 draws: incidence, speed and direction
    uniform, and a noisy ancillary wind (numpy float64)."""
    rng = np.random.default_rng(0)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    return inc, wspd, phi, anc


def make_scene(n, device):
    """The JAX script's seed-0 scene: :func:`draw_scene`, with copol
    sigma0 (dB) forward-modelled with ``gmf_cmod5n`` in float64 on
    ``device``."""
    inc, wspd, phi, anc = draw_scene(n)
    s0 = get_model("gmf_cmod5n")(*(torch.as_tensor(a, device=device) for a in (inc, wspd, phi)),
                                 broadcast=True).cpu().numpy()
    return inc, 10 * np.log10(s0 + 1e-15), anc


def prepare(tables, inc, s0_db, anc, device, dsig_co=DSIG_CO):
    """Stage 1 of the fused inversion (``_make_fused_invert_fn.run``) on the
    scene, then each form's K5 arguments. Returns ``(args, perm2)``:
    ``args[form]`` is the positional argument tuple of
    :func:`E.slab_forms`, and ``perm2`` the pixel of each slab slot (-1 for
    padding)."""
    f32 = torch.float32
    lut = np.asarray(tables.co_lut, np.float32)
    u = np.asarray(tables.co_u, np.float32)
    v = np.asarray(tables.co_v, np.float32)
    step_w = float(np.median(np.diff(np.asarray(tables.co_wspd, np.float64))))
    step_p = float(np.median(np.diff(np.asarray(tables.co_phi, np.float64))))
    lut_c, u_c, v_c, row_group, n_wgroups = K.build_coarse_arrays(
        lut, u, v, stride_w=max(1, round(inv._COARSE_DW / step_w)),
        stride_p=max(1, round(inv._COARSE_DPHI / step_p)))
    ops = {form: E.build_form_arrays(form, lut, u, v, dsig_co) for form in E.FORMS}
    n_inc, wp_rows = ops["direct"][0].shape[:2]
    inv_dsig = float(np.float32(1.0 / dsig_co))

    def dev(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    n = inc.shape[0]
    s0, ma, mz = dev(s0_db), dev(anc.real), dev(np.abs(anc.imag))
    inc_grid = dev(np.asarray(tables.co_inc, np.float64))
    perm, band_of_block = bucket_by_band(nearest_index_sorted(inc_grid, dev(inc)), n_inc,
                                         K.GROUP_BLOCK)
    base = torch.stack([s0, ma * 0.5, mz * 0.5, torch.full((n,), inv_dsig, device=device)], 1)
    gstar = K.group_argmin(*(dev(a) for a in (lut_c, u_c, v_c)),
                           dev(row_group, torch.int32), base, band_of_block, n_wgroups,
                           block=K.GROUP_BLOCK, index=perm).reshape(-1)
    perm2, key_of_block = inv._rebucket_slot(perm, gstar, band_of_block, n_inc=n_inc,
                                             n_wgroups=n_wgroups, block=K.GROUP_BLOCK,
                                             slab_block=K.SLAB_BLOCK)
    valid2 = perm2 >= 0
    sband = torch.div(key_of_block, n_wgroups, rounding_mode="floor")
    srow0 = torch.clamp((key_of_block % n_wgroups) * K.WGROUP - K.SLAB_MARGIN, 0,
                        wp_rows - K.SLAB_ROWS)
    vmask = valid2.reshape(-1, K.SLAB_BLOCK).any(dim=1).to(torch.int32)
    pre = torch.stack([s0 * inv_dsig, ma * 0.5, mz * 0.5, torch.ones(n, device=device)], 1)
    feats = {"direct": base, "prescaled": pre, "expanded_uv": pre}
    args = {}
    for form in E.FORMS:
        lut_f, u_f, v_f, kr_f = ops[form]
        f2 = torch.where(valid2[:, None], feats[form][perm2.clamp(min=0)], float("nan"))
        args[form] = (form, dev(lut_f), dev(u_f), dev(v_f), None if kr_f is None else dev(kr_f),
                      f2, sband, srow0, vmask)
    return args, perm2


def flip_accounting(tables, outs, perm2, sband, s0_db, anc, dsig_co=DSIG_CO):
    """Each rewrite's flat indices against ``direct``'s on the valid slots
    where both found a winner: the flips, and, in float64 direct-form cost,
    how many flipped winners are better, worse or tied, the largest cost
    difference and the largest wind-speed difference."""
    n_phi = tables.co_lut.shape[2]
    pix = perm2.cpu().numpy().reshape(-1)
    mask = pix >= 0
    baseline = outs["direct"]
    lut64 = np.asarray(tables.co_lut, np.float64)
    u64 = np.asarray(tables.co_u, np.float64)
    v64 = np.asarray(tables.co_v, np.float64)
    w64 = np.asarray(tables.co_wspd, np.float64)
    sband_px = np.repeat(sband.cpu().numpy(), K.SLAB_BLOCK)
    p = np.clip(pix, 0, None)
    s0_px = np.where(mask, s0_db[p], np.nan)
    ma_px = np.where(mask, anc.real[p], np.nan)
    mz_px = np.where(mask, np.abs(anc.imag[p]), np.nan)

    def j64(flat, sel):
        w_i, p_i = flat[sel] // n_phi, flat[sel] % n_phi
        return (((lut64[sband_px[sel], w_i, p_i] - s0_px[sel]) / dsig_co) ** 2
                + ((u64[w_i, p_i] - ma_px[sel]) / 2.0) ** 2
                + ((v64[w_i, p_i] - mz_px[sel]) / 2.0) ** 2)

    report = {}
    for form in E.FORMS[1:]:
        o = outs[form]
        flips = mask & (o != baseline) & (baseline < _BIG_IDX) & (o < _BIG_IDX)
        r = {"flips": int(flips.sum()), "valid": int(mask.sum()), "better": 0, "worse": 0,
             "tie": 0, "max_abs_dJ": 0.0, "max_abs_dwspd_m_s": 0.0}
        if r["flips"]:
            sel = np.nonzero(flips)[0]
            jb, jo = j64(baseline, sel), j64(o, sel)
            r.update(better=int((jo < jb).sum()), worse=int((jo > jb).sum()),
                     tie=int((jo == jb).sum()), max_abs_dJ=float(np.abs(jo - jb).max()),
                     max_abs_dwspd_m_s=float(np.abs(w64[o[sel] // n_phi]
                                                    - w64[baseline[sel] // n_phi]).max()))
        report[form] = r
    return report


def main(n=N, device="cuda", **lut_kw):
    """Run the experiment and print its lines; ``lut_kw`` (e.g. ``inc_step``)
    goes to ``to_lut`` (the default is the high-resolution LUT). Returns
    ``{"forms": {form: {"args", "out", "ms", "ns_per_px", "thread": {"out",
    "ms", "ns_per_px"}}}, "flips": {form: {...}}, "n", "slots"}``: the top
    level of a form is its shared loop, ``thread`` the baseline loop; times
    are None on the CPU."""
    dev = device_of(device)
    tables = inv.prepare_tables("gmf_cmod5n", None, dtype=torch.float32, **lut_kw)
    inc, s0_db, anc = make_scene(n, dev)
    args, perm2 = prepare(tables, inc, s0_db, anc, dev)
    slots = int(perm2.shape[0])
    print(f"pixels {n} | slab rows {K.SLAB_ROWS} | LUT {tables.co_lut.shape} | slots {slots} "
          f"in {slots // K.SLAB_BLOCK} blocks of {K.SLAB_BLOCK} | device {dev}", flush=True)
    forms = {}
    for form in E.FORMS:
        a = args[form]
        runs = {loop: E.slab_forms(*a, loop=loop) for loop in E.LOOPS}
        times = cuda_ms_turns({loop: (lambda lp=loop: E.slab_forms(*a, loop=lp))
                               for loop in E.LOOPS}, rounds=REPS) if dev.type == "cuda" else {}
        res = {}
        for loop in E.LOOPS:
            ms = times.get(loop)
            res[loop] = {"out": runs[loop], "ms": ms,
                         "ns_per_px": None if ms is None else ms * 1e6 / n}
            timing = "not timed (plain version on the CPU)" if ms is None else \
                f"{ms:9.3f} ms   {ms * 1e6 / n:6.2f} ns/px"
            print(f"slab form={form:12s} loop={loop:6s} {timing}", flush=True)
        same = bool(torch.equal(runs["shared"], runs["thread"]))
        print(f"slab form={form:12s} loops bit-equal: {same}", flush=True)
        forms[form] = {"args": a, **res["shared"], "thread": res["thread"]}

    outs = {form: r["out"].cpu().numpy().reshape(-1) for form, r in forms.items()}
    flips = flip_accounting(tables, outs, perm2, args["direct"][6], s0_db, anc)
    for form, r in flips.items():
        line = f"{form}: flips vs direct = {r['flips']} / {r['valid']}"
        if r["flips"]:
            line += (f" | f64 says flip better {r['better']}, worse {r['worse']}, "
                     f"tie {r['tie']} | max |dJ| {r['max_abs_dJ']:.3e}"
                     f" | max |dwspd| {r['max_abs_dwspd_m_s']:.3f} m/s")
        print(line, flush=True)
    return {"forms": forms, "flips": flips, "n": n, "slots": slots}


if __name__ == "__main__":
    main()
