"""Micro-benchmark the coarse pass's expanded-form variants (K6), on the GPU.

Port of ``scripts/bench_kernel_variants.py``: the TPU's coarse
group-argmin kernel as a K = 4 product ``g4[band, tile]^T . feats`` over
4 tiles x 2048 entries, reduced to 32 group rows per pixel, in isolation,
to price its components: the matmul precision (``highest`` float32, or
``default``, both operands rounded to bf16), the group-min reduction
(``reshape`` and ``static_slices``, two TPU codegen routes to one function
and one code path here; ``flat_min``, one row per tile; ``none``, no
reduction: the first 8 entries of a tile are its rows) and the pixel block
size. It runs the JAX script's nine variants at 2**23 pixels on random
operands drawn from ``numpy.random.default_rng(0)`` in the JAX script's
order (g4 first, then feats and the sorted bands per variant), on both of
K6's engines: ``cuda_cores``, one thread a pixel, the product on the FP32
pipe, and ``tensor_cores``, the product on mma.sync as the TPU's matrix
unit computes it (bf16, or three-term bf16 splits at ``highest``). It
prints the one-off split of g4 into the tensor cores' operand per
precision, then each variant's device time and rate on both engines, timed
in turns (CUDA events, medians of 3 after a warm-up), and how many pixels'
groups the two engines give differently.

On either engine a reduction costs one FP32 minimum per entry, folded in
registers; ``none`` never reads the entries it would discard.

Run: ``python -m xsarsea_tpu_torch.scripts.bench_kernel_variants``. It
needs a CUDA device; :func:`main` runs the plain versions on the CPU only
when called with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.scripts import cuda_ms, cuda_ms_turns, device_of

N = 1 << 23
N_INC = 501
REPS = 3
# (label, block, reduction, precision): scripts/bench_kernel_variants.py:101-109
VARIANTS = (
    ("block=256 reshape HIGHEST (current)", 256, "reshape", "highest"),
    ("block=256 static_slices HIGHEST", 256, "static_slices", "highest"),
    ("block=256 flat_min HIGHEST", 256, "flat_min", "highest"),
    ("block=256 none HIGHEST", 256, "none", "highest"),
    ("block=256 none DEFAULT", 256, "none", "default"),
    ("block=512 reshape HIGHEST", 512, "reshape", "highest"),
    ("block=1024 reshape HIGHEST", 1024, "reshape", "highest"),
    ("block=1024 static_slices HIGHEST", 1024, "static_slices", "highest"),
    ("block=1024 none DEFAULT", 1024, "none", "default"),
)


def make_g4(rng):
    return rng.normal(size=(N_INC, E.G4_TILES, 4, E.G4_TILE)).astype(np.float32)


def make_inputs(rng, block, n):
    """One variant's feats (n_blocks, 4, block) and sorted band per block,
    drawn as the JAX script's ``make_variant`` draws them."""
    n_blocks = n // block
    feats = rng.normal(size=(n_blocks, 4, block)).astype(np.float32)
    band_of_block = np.sort(rng.integers(0, N_INC, n_blocks)).astype(np.int32)
    return feats, band_of_block


def _timing(r):
    return "not timed" if r["ms"] is None else f"{r['ms']:8.3f} ms {r['mpx_s']:8.2f} Mpx/s"


def main(n=N, device="cuda"):
    """Run the variants and print a line each. Returns :func:`run`'s list
    of variants."""
    return run(n, device)["variants"]


def run(n=N, device="cuda"):
    """Split g4 for the tensor cores, then run every variant on both
    engines. Returns ``{"variants": [{"label", "args", "kwargs", "out",
    "ms", "mpx_s", "tensor_cores": {"out", "ms", "mpx_s"}, "differ"}, ...],
    "g4_split": {precision: tensor}, "split_ms": {precision: ms}}``: a
    variant's top level is its CUDA-core run, ``differ`` the pixels whose
    groups the engines give differently; times are None on the CPU."""
    dev = device_of(device)
    rng = np.random.default_rng(0)
    g4 = torch.as_tensor(make_g4(rng), device=dev)
    print(f"pixels {n} | g4 {tuple(g4.shape)} | device {dev}", flush=True)
    g4_split, split_ms = {}, {}
    for precision in E.PRECISIONS:
        g4_split[precision] = E.split_g4(g4, precision)
        split_ms[precision] = cuda_ms(lambda p=precision: E.split_g4(g4, p), REPS) \
            if dev.type == "cuda" else None
        timing = "not timed (plain version on the CPU)" if split_ms[precision] is None else \
            f"{split_ms[precision]:8.3f} ms"
        print(f"split_g4 precision={precision:8s} {timing} -> "
              f"{g4_split[precision].numel() * 4 / 2 ** 20:.0f} MiB", flush=True)
    results = []
    for label, block, reduction, precision in VARIANTS:
        feats, band_of_block = make_inputs(rng, block, n)
        args = (g4, torch.as_tensor(feats, device=dev), torch.as_tensor(band_of_block, device=dev))
        kwargs = dict(block=block, reduction=reduction, precision=precision)
        engines = {"cuda_cores": {}, "tensor_cores": {"g4_split": g4_split[precision]}}
        calls = {e: (lambda kw=kw, e=e: E.group_argmin_variant(*args, **kwargs, engine=e, **kw))
                 for e, kw in engines.items()}
        outs = {e: fn() for e, fn in calls.items()}
        times = cuda_ms_turns(calls, rounds=REPS) if dev.type == "cuda" else {}
        res = {}
        for e in E.ENGINES:
            ms = times.get(e)
            res[e] = {"out": outs[e], "ms": ms, "mpx_s": None if ms is None else n / ms / 1e3}
        differ = int((outs["cuda_cores"] != outs["tensor_cores"]).sum())
        note = "  (one function with reshape on this card)" if reduction == "static_slices" \
            else ""
        print(f"{label:40s} cuda_cores {_timing(res['cuda_cores'])} | tensor_cores "
              f"{_timing(res['tensor_cores'])} | groups differ on {differ} px{note}", flush=True)
        results.append({"label": label, "args": args, "kwargs": kwargs, **res["cuda_cores"],
                        "tensor_cores": res["tensor_cores"], "differ": differ})
    return {"variants": results, "g4_split": g4_split, "split_ms": split_ms}


if __name__ == "__main__":
    main()
