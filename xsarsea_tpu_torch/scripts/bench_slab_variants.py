"""Chunk-height experiment for the slab sweep (K2 and K3), on the GPU.

Port of ``scripts/bench_slab_variants.py``. The TPU script times
``rows_per_iter``, the partial unroll of the Pallas slab loop: the per-row
operations do not change with it, so the outputs must be bit-equal. The
port's counterpart of that knob is the chunk height of ``xs::slab::sweep``
(``csrc/inversion_common.cuh``): the slab rows one shared-memory stage
holds (``K.CHUNK_ROWS``: 8 on every path, 16, 24 and 48 here). The height
changes the trip counts and the shared memory a block takes (and with it
how many blocks an SM holds), never the per-entry operations.

On the JAX script's 2**23-pixel seed-0 scene (``gmf_cmod5n`` copol,
``gmf_s1_v2`` crosspol on the same incidence axis, ``dsig_co`` 0.1,
``dsig_cr`` 0.1), bucketed by the port's own stages 1-4 (nearest incidence
band, K1, the re-bucketing by (band, group), the 48-row slabs), it times K3
(``K.slab_refine``) and K2 (``K.slab_refine_fused``) at each height, in
turns (CUDA events, medians of 3 after a warm-up), and holds each height's
outputs bit-equal to 8's on the blocks that are not all padding, as the JAX
script's ``vmask`` comparison does. A height whose stages do not fit a
block's shared memory is refused by the wrapper with the bytes it needs,
and printed ``FAILED``, as the JAX script prints a VMEM overflow. The JAX
script's pack-2 lane layout is a TPU layout and has no counterpart here.

Run: ``python -m xsarsea_tpu_torch.scripts.bench_slab_variants``. It needs
a CUDA device; :func:`main` runs the plain versions on the CPU only when
called with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.scripts import bench_slab_forms, cuda_ms_turns, device_of
from xsarsea_tpu_torch.windspeed import inversion as inv

N = 1 << 23
REPS = 3
DSIG_CR = 0.1


def prepare(tables, n, device):
    """The scene and its stage 1-4 arguments: ``{"slab_refine": K3's
    positional arguments, "slab_refine_fused": K2's}`` (``has_cr=True``,
    48-row slabs), their feature rows in slot order (read through the
    identity index, so the results come back in slot order)."""
    inc, wspd, phi, anc = bench_slab_forms.draw_scene(n)
    dev = [torch.as_tensor(a, device=device) for a in (inc, wspd, phi)]
    s0 = get_model("gmf_cmod5n")(*dev, broadcast=True).cpu().numpy()
    s0_cr = get_model("gmf_s1_v2")(dev[0], dev[1], broadcast=True).cpu().numpy()
    s0_db, s0_cr_db = (10 * np.log10(a + 1e-15) for a in (s0, s0_cr))
    args, perm2 = bench_slab_forms.prepare(tables, inc, s0_db, anc, device)
    _, lut, u, v, _, feats4, sband, srow0, vmask = args["direct"]
    valid2 = (perm2 >= 0)[:, None]
    cross = torch.stack([torch.as_tensor(s0_cr_db, device=device).to(torch.float32),
                         torch.full((n,), DSIG_CR, device=device)], 1)
    feats8 = torch.cat([feats4, cross[perm2.clamp(min=0)], torch.zeros_like(feats4[:, :2])], 1)
    feats8 = torch.where(valid2, feats8, float("nan"))  # padding slots: every column NaN
    w_pad = torch.as_tensor(K.build_decode_arrays(tables.co_wspd, lut.shape[1]), device=device)
    co_phir = torch.as_tensor(np.asarray(tables.co_phir, np.float32), device=device)
    cr_lut, cr_whalf = (torch.as_tensor(a, device=device)
                        for a in K.build_crosspol_arrays(tables.cr_lut, tables.cr_wspd))
    return {"slab_refine": (lut, u, v, feats4, sband, srow0, vmask),
            "slab_refine_fused": (lut, u, v, w_pad, co_phir, cr_lut, cr_whalf, feats8, sband,
                                  srow0, vmask)}


def main(n=N, device="cuda", **lut_kw):
    """Run the experiment and print its lines; ``lut_kw`` (e.g. ``inc_step``)
    goes to ``to_lut`` (the default is the high-resolution LUT). Returns
    ``{"args": {kernel: args}, "index", "kernels": {kernel: {chunk_rows:
    {"out", "ms", "equal"}}}, "refused": {kernel: {chunk_rows: message}},
    "n", "slots"}``, ``index`` the identity the kernels read the rows
    through, kernel ``slab_refine`` (K3) or ``slab_refine_fused`` (K2),
    ``equal`` whether the height's outputs are bit-equal to 8's on the
    blocks that are not all padding; times are None on the CPU."""
    dev = device_of(device)
    tables = inv.prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, **lut_kw)
    args = prepare(tables, n, dev)
    vmask = args["slab_refine"][-1].to(torch.bool)
    slots = int(args["slab_refine"][3].shape[0])
    index = torch.arange(slots, device=dev)  # the rows are in slot order already
    live = vmask.repeat_interleave(K.SLAB_BLOCK)  # the slots of blocks not all padding
    print(f"pixels {n} | slab rows {K.SLAB_ROWS} | LUT {tables.co_lut.shape} | slots {slots} "
          f"in {vmask.numel()} blocks ({int(vmask.sum())} not all padding) | device {dev}",
          flush=True)
    kernels, refused = {}, {}
    for name, a in args.items():
        fn = getattr(K, name)
        calls, outs, refused[name] = {}, {}, {}
        for rows in K.CHUNK_ROWS:
            try:
                outs[rows] = fn(*a, chunk_rows=rows, index=index)
            except ValueError as e:  # a height whose stages do not fit shared memory
                refused[name][rows] = str(e)
                print(f"{name} chunk_rows={rows:2d}  FAILED: {type(e).__name__}: {e}",
                      flush=True)
                continue
            calls[rows] = lambda fn=fn, a=a, rows=rows: fn(*a, chunk_rows=rows, index=index)
        times = cuda_ms_turns(calls, rounds=REPS) if dev.type == "cuda" else {}
        kernels[name] = {}
        for rows, out in outs.items():
            equal = bool(torch.equal(out[..., live], outs[8][..., live]))
            ms = times.get(rows)
            kernels[name][rows] = {"out": out, "ms": ms, "equal": equal}
            timing = "not timed (plain version on the CPU)" if ms is None else \
                f"{ms:9.3f} ms   {ms * 1e6 / n:6.2f} ns/px"
            print(f"{name} chunk_rows={rows:2d} {timing}   bit-equal vs 8: {equal}",
                  flush=True)
    return {"args": args, "index": index, "kernels": kernels, "refused": refused, "n": n,
            "slots": slots}


if __name__ == "__main__":
    main()
