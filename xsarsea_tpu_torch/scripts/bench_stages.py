"""Stage-level timing of the fused inversion pipeline.

Port of ``scripts/bench_stages.py``. Rebuilds the pipeline of
``windspeed.inversion._make_fused_invert_fn`` (the fused tail: LUTs on one
incidence axis) as separately timed stages, at the headline scale of 2**23
px on the high-resolution ``gmf_cmod5n`` + ``gmf_s1_v2`` tables, float32,
device-resident:

1. bucketing by incidence band (``bucket_by_value``);
2. the stage-1 feature gather (``pix[perm]``, ``inversion.py:455``), the
   feature columns' build included;
3. K1, the coarse group argmin;
4. the (band, group) re-bucketing (``_rebucket_slot``) with the slab rows
   and the block mask;
5. the stage-2 feature gather (``pix[perm2]``, ``inversion.py:469``);
6. K2, slab refine + decode + crosspol argmin;
7. the scatter back to pixel order and ``_postprocess_vectorized``.

Each stage is timed with CUDA events, median of 3 after a warm-up, and
printed in ms and ns/px; then the sum of the stages beside one whole call of
the production closure, whose output the stages must reproduce bit for bit.
The sum may exceed the call: a stage timed alone pays its own launches and
host waits, as the JAX script says of XLA's fusion across its stages.

Run: ``python -m xsarsea_tpu_torch.scripts.bench_stages`` on the card.
:func:`main` with ``device="cpu"`` runs the plain kernel versions (a small
``n`` and reduced ``table_kwargs`` keep that quick).
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.bucketing import _f32_sort_key_np, band_boundaries_f32, bucket_by_value
from xsarsea_tpu_torch.scripts import device_of, median_ms
from xsarsea_tpu_torch.windspeed import inversion as inv

N = 1 << 23


def make_pixels(n, device):
    """The benchmark's pixels (seed 0: incidence U(18, 47) deg, speed
    U(0.5, 45) m/s, direction U(0, 360) deg, ancillary noise N(0, 1.5)),
    sigma0 forward-modelled in float64 on ``device``, as float32 tensors:
    (inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im)."""
    rng = np.random.default_rng(0)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    f64 = [torch.as_tensor(a, device=device) for a in (inc, wspd, phi)]
    s0_co = get_model("gmf_cmod5n")(*f64, broadcast=True)
    s0_cr = get_model("gmf_s1_v2")(f64[0], f64[1], broadcast=True)
    cols = [f64[0], 10 * torch.log10(s0_co + 1e-15), 10 * torch.log10(s0_cr + 1e-15),
            torch.full_like(f64[0], 0.1), torch.as_tensor(anc.real, device=device),
            torch.as_tensor(anc.imag, device=device)]
    return [c.to(torch.float32).contiguous() for c in cols]


class _Pipeline:
    """The operands ``_make_fused_invert_fn`` builds for the fused tail, and
    its stages one by one."""

    def __init__(self, tables, device):
        margin = inv._COARSE_MARGIN
        self.slab_rows = K.WGROUP + 2 * margin
        self.margin = margin
        co_wspd = np.asarray(tables.co_wspd, np.float64)
        step_w = float(np.median(np.diff(co_wspd)))
        step_p = float(np.median(np.diff(np.asarray(tables.co_phi, np.float64))))
        lut = np.asarray(tables.co_lut, np.float32)
        u = np.asarray(tables.co_u, np.float32)
        v = np.asarray(tables.co_v, np.float32)
        lut_c, u_c, v_c, row_group, self.n_wgroups = K.build_coarse_arrays(
            lut, u, v, stride_w=max(1, round(inv._COARSE_DW / step_w)),
            stride_p=max(1, round(inv._COARSE_DPHI / step_p)))
        lut_pad, u_pad, v_pad = K.build_direct_arrays(lut, u, v)
        self.n_inc, self.wp_rows, self.n_phi = lut_pad.shape
        w_pad = K.build_decode_arrays(tables.co_wspd, self.wp_rows)

        def to_dev(a):
            return torch.as_tensor(a, device=device)

        self.k1_ops = tuple(to_dev(a) for a in (lut_c, u_c, v_c, row_group))
        self.direct = tuple(to_dev(a) for a in (lut_pad, u_pad, v_pad, w_pad))
        self.co_phir = to_dev(np.asarray(tables.co_phir, np.float32))
        self.cr_ops = tuple(to_dev(a) for a in K.build_crosspol_arrays(tables.cr_lut,
                                                                        tables.cr_wspd))
        bounds = band_boundaries_f32(np.asarray(tables.co_inc, np.float32))
        if bounds is None:
            raise ValueError("bench_stages needs an incidence grid with float32 band boundaries")
        self.boundary_keys = to_dev(_f32_sort_key_np(bounds))
        self.phi_180 = tables.phi_180

    def bucket(self, inc):
        return bucket_by_value(inc, self.boundary_keys, self.n_inc, K.GROUP_BLOCK)

    def pix(self, inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, dsig_co):
        n = inc.shape[0]
        f32 = torch.float32
        mz = torch.abs(anc_im) if self.phi_180 else anc_im
        zero = torch.zeros(n, dtype=f32, device=inc.device)
        return torch.stack([s0_co_db, anc_re * 0.5, mz * 0.5, (1.0 / dsig_co).to(f32).expand(n),
                            s0_cr_db, dsig_cr, zero, zero], dim=1)

    @staticmethod
    def gather1(pix, perm):
        return torch.where((perm >= 0)[:, None], pix[perm.clamp(min=0), :4], float("nan"))

    def k1(self, feats1, band_of_block):
        return K.group_argmin(*self.k1_ops, feats1, band_of_block, self.n_wgroups,
                              block=K.GROUP_BLOCK).reshape(-1)

    def rebucket(self, perm, gstar, band_of_block):
        perm2, key_of_block = inv._rebucket_slot(
            perm, gstar, band_of_block, n_inc=self.n_inc, n_wgroups=self.n_wgroups,
            block=K.GROUP_BLOCK, slab_block=K.SLAB_BLOCK)
        valid2 = perm2 >= 0
        sband = torch.div(key_of_block, self.n_wgroups, rounding_mode="floor")
        srow0 = torch.clamp((key_of_block % self.n_wgroups) * K.WGROUP - self.margin, 0,
                            self.wp_rows - self.slab_rows)
        vmask = valid2.reshape(-1, K.SLAB_BLOCK).any(dim=1)
        return perm2, valid2, sband, srow0, vmask

    @staticmethod
    def gather2(pix, perm2, valid2):
        return torch.where(valid2[:, None], pix[perm2.clamp(min=0)], float("nan"))

    def k2(self, feats2, sband, srow0, vmask):
        return K.slab_refine_fused(*self.direct, self.co_phir, *self.cr_ops, feats2, sband,
                                   srow0, vmask, has_cr=True, block=K.SLAB_BLOCK,
                                   n_rows=self.slab_rows)

    def finish(self, vals, perm2, valid2, inputs):
        inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im = inputs
        n = inc.shape[0]
        slots = vals.permute(1, 0, 2).reshape(4, -1)[:, valid2]
        res = torch.empty((3, n), dtype=torch.float32, device=inc.device)
        res[:, perm2[valid2]] = slots[:3]
        return inv._postprocess_vectorized(
            inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, res[0], torch.cos(res[1]),
            torch.sin(res[1]), res[1], res[2], phi_180=self.phi_180, has_cr=True)


def main(n=N, device="cuda", reps=3, table_kwargs=None, log=print):
    """Time the stages on ``n`` pixels; returns ``{"n", "stages": [(name,
    ms), ...], "sum_ms", "call_ms"}``. Exits unless the stages reproduce the
    production closure's output bit for bit."""
    dev = device_of(device)
    tables = inv.prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32,
                                **(table_kwargs or {}))
    if not np.array_equal(np.asarray(tables.co_inc, np.float64),
                          np.asarray(tables.cr_inc, np.float64)):
        raise ValueError("bench_stages times the fused tail: the LUTs must share their "
                         "incidence axis")
    inputs = make_pixels(n, dev)
    dsig_co = torch.tensor(0.1, dtype=torch.float32, device=dev)
    p = _Pipeline(tables, dev)
    log(f"pixels {n} | LUT (I, W, P) = {tables.co_lut.shape} | coarse grid "
        f"{tuple(p.k1_ops[1].shape)} | slab rows {p.slab_rows} | device {dev}")

    stages = []

    def stage(name, fn):
        out, ms = median_ms(fn, dev, reps)
        stages.append((name, ms))
        log(f"{name:44s} {ms:9.3f} ms   {ms * 1e6 / n:7.2f} ns/px")
        return out

    perm, band_of_block = stage("1 bucket by incidence", lambda: p.bucket(inputs[0]))
    pix, feats1 = stage("2 features + gather pix[perm]", lambda: (
        lambda px: (px, p.gather1(px, perm)))(p.pix(*inputs, dsig_co)))
    gstar = stage("3 K1 group_argmin", lambda: p.k1(feats1, band_of_block))
    perm2, valid2, sband, srow0, vmask = stage("4 rebucket (band, group)",
                                               lambda: p.rebucket(perm, gstar, band_of_block))
    feats2 = stage("5 gather pix[perm2]", lambda: p.gather2(pix, perm2, valid2))
    vals = stage("6 K2 slab_refine_fused", lambda: p.k2(feats2, sband, srow0, vmask))
    got = stage("7 scatter to pixel order + postprocess",
                lambda: p.finish(vals, perm2, valid2, inputs))
    total = sum(ms for _, ms in stages)
    log(f"{'sum of stages':44s} {total:9.3f} ms   {total * 1e6 / n:7.2f} ns/px  -> "
        f"{n / total / 1e3:.2f} Mpx/s")

    fn = inv._get_invert_fn(tables, 256, "fused", dev)
    ref, call_ms = median_ms(lambda: fn(*inputs, dsig_co), dev, reps)
    log(f"{'whole call (production closure)':44s} {call_ms:9.3f} ms   "
        f"{call_ms * 1e6 / n:7.2f} ns/px  -> {n / call_ms / 1e3:.2f} Mpx/s")
    if not all(torch.equal(torch.nan_to_num(a, 1e30), torch.nan_to_num(b, 1e30))
               and torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(got, ref)):
        raise SystemExit("bench_stages: the stages differ from the production closure")
    return {"n": n, "stages": stages, "sum_ms": total, "call_ms": call_ms}


if __name__ == "__main__":
    main()
